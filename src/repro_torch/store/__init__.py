"""repro_torch.store — host-memory designs for non-resident handles.

  store.py  HostDesign (the design's host copy in the transposed layout,
            pinned when the handle's device is a GPU) and StoreBlockSource
            (the per-block fetch interface the ``bakp_stream`` method's
            host loop reads).

The tiered ``DesignStore`` of ``repro.store`` (device / host / disk tiers,
CRC-checked tiles, quarantine) is not ported yet.
"""
from repro_torch.store.store import HostDesign, StoreBlockSource

__all__ = ["HostDesign", "StoreBlockSource"]
