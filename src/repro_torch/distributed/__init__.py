"""repro_torch.distributed — the logical-axis sharding rules
(``sharding``), int8 gradient compression with error feedback
(``compression``) and the fault-tolerance substrate
(``fault_tolerance``)."""
