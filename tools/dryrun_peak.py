#!/usr/bin/env python3
"""What makes a dry-run cell's peak: the largest tensors alive when
``launch/op_analysis`` records the cell's ``temp_bytes`` peak.

    PYTHONPATH=src python3 tools/dryrun_peak.py --arch whisper_medium \
        --cell train_4k [--multi-pod] [--top 12]

Runs the cell once as ``launch.dryrun`` does (rank 0 of a placeholder
world, fake tensors, the CPU) with the analysis's storage tracking
wrapped to remember each storage's op, shape and dtype; at each new peak
it keeps the largest live storages and the live bytes by op.  Prints the
dry run's row, then those.  Modeled from shapes, not measured.
"""

from __future__ import annotations

import argparse
import collections
import weakref


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.launch import dryrun
    from repro_torch.launch import op_analysis as oa

    desc, peak, current = {}, {}, {"op": None}
    dispatch = oa._Analysis.__torch_dispatch__

    def torch_dispatch(self, func, types, args=(), kwargs=None):
        current["op"] = str(func)
        return dispatch(self, func, types, args, kwargs)

    def track(self, t):
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = n = st.nbytes()
        desc[key] = (n, current["op"], tuple(t.shape), str(t.dtype))
        self._live_bytes += n
        if self._live_bytes > self.cost.peak_bytes:
            self.cost.peak_bytes = self._live_bytes
            live = [desc[k] for k in self._live]
            by_op = collections.Counter()
            for n_, op, _, _ in live:
                by_op[op] += n_
            peak.update(top=sorted(live, reverse=True)[:args.top],
                        by_op=by_op.most_common(args.top))
        weakref.finalize(st, self._free, key)

    oa._Analysis.__torch_dispatch__ = torch_dispatch
    oa._Analysis._track = track
    with dryrun.placeholder_world(512 if args.multi_pod else 256):
        dryrun.run_cell(args.arch, args.cell, args.multi_pod)
    gib = 2 ** 30
    print("largest live tensors at the peak (GiB, op, shape, dtype):")
    for n, op, shape, dtype in peak.get("top", []):
        print(f"  {n / gib:.3f}  {op}  {shape}  {dtype}")
    print("live bytes at the peak by the op that made them (GiB):")
    for op, n in peak.get("by_op", []):
        print(f"  {n / gib:.2f}  {op}")


if __name__ == "__main__":
    main()
