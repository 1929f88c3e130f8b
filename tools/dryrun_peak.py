#!/usr/bin/env python3
"""What the dry run's per-device peak is made of: the largest buffers live
at its high-water mark, and the ops that made them.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch qwen2-vl-2b \
        --cell train_4k --layers 2 [--multi-pod]

Runs ``launch.dryrun.run_cell`` (DTensors over a fake process group,
``meta`` shards; no device) with the config's ``n_layers`` cut to
``--layers`` (its widths as published), and records, each time the live
bytes reach a new high, which op made each live storage.  Prints one JSON
object: the cell's ``memory_analysis``, live bytes at the peak by op, and
the six largest buffers there (op, per-device shape, dtype).
"""
import argparse
import collections
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", default="train_4k")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.launch import cost_analysis, dryrun

    peak = {}

    class Traced(cost_analysis.CostModel):
        """The cost model, remembering the op that made each storage."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self._op = str(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _mark(self, t, alloc=False):
            before = self.peak_live
            super()._mark(t, alloc)
            if not alloc:
                return
            made = self.__dict__.setdefault("_made", {})
            made[t.untyped_storage()._cdata] = (
                getattr(self, "_op", "?"), list(t.shape), str(t.dtype))
            if self.peak_live > before:
                by_op = collections.Counter()
                sizes = []
                for key, (n, _) in self._storages.items():
                    op = made.get(key, ("?", [], ""))
                    by_op[op[0]] += n
                    sizes.append((n, op))
                peak["by_op"] = by_op.most_common(8)
                peak["largest"] = sorted(sizes, reverse=True)[:6]

    cost_analysis.CostModel = Traced
    r = dryrun.run_cell(args.arch, args.cell, multi_pod=args.multi_pod,
                        overrides={"n_layers": args.layers})
    print(json.dumps({
        "arch": args.arch, "cell": args.cell, "layers": args.layers,
        "mesh": r["mesh"], "memory_analysis": r["memory_analysis"],
        "peak_bytes_by_op": peak.get("by_op"),
        "largest_at_peak": [{"bytes": n, "op": o[0], "shape": o[1],
                             "dtype": o[2]} for n, o in
                            peak.get("largest", [])]}, indent=1))


if __name__ == "__main__":
    main()
