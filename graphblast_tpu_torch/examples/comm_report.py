"""The communication accounting as a report: each distributed algorithm's
per-iteration link traffic a rank beside its local memory traffic, and
the projected no-overlap scaling efficiency, for RMAT graphs of scale 18,
22 and 25 (edge factor 16, undirected) over P = 8 cards, at a sparse (1%
of the edges) and a dense-ish (30%) frontier.

    python -m graphblast_tpu_torch.examples.comm_report [--out PATH]

It prints the report, or writes it to --out. The formulas are
graphblast_tpu_torch/parallel/accounting.py's, cross-checked against the
sparse push's owner bucketing by tests/test_torch_dist.py and the chip
check. The rates are datasheet figures, not measurements (accounting.py).
"""
from __future__ import annotations

import argparse
import sys

from ..parallel import accounting as acc

P = 8

HEADER = f"""# Distributed communication accounting

Per-rank, per-iteration link traffic of each distributed algorithm,
computed from the partition's shapes
(`graphblast_tpu_torch/parallel/accounting.py`), beside the local memory
traffic and the projected compute fraction over {P} cards of one node.
The CPU tests check the exchanges' results on gloo ranks, not their time,
so the volumes are derived and cross-checked: the sparse push's owner
bucketing (`parallel.ops.owner_buckets`) counts the live pairs that
`accounting.sparse_push_live_pairs` predicts, in tests/test_torch_dist.py
and in the chip check.

The collective cost model is the ring decomposition: an all-gather or a
reduce-scatter moves (P-1)/P of its payload a rank, an all-to-all
(P-1) blocks, a ring stage one block.

The efficiency columns are the SCALING efficiency: with t_comp =
memory bytes / HBM rate and t_comm = link bytes / link rate, edges/s at P
cards over P x edges/s at one card is t_comp / (t_comp + t_comm) when the
one-card run is memory-bound (no overlap, a lower bound for the ring
variants).

Rates (datasheet figures, not measurements): H100 80GB HBM3 SXM at 700 W,
HBM3 {acc.H100_HBM_GBS:,.0f} GB/s; NVLink 4 {acc.H100_NVLINK_GBS:,.0f} GB/s a
direction; PCIe Gen5 x16 {acc.PCIE5_X16_GBS:,.0f} GB/s a direction as the
sensitivity column.
"""


def sections() -> list:
    out = []
    for scale, ef in ((18, 16), (22, 16), (25, 16)):
        n = 1 << scale
        nnz = ef * n * 2     # undirected doubling
        pair_cap = max(nnz // 2 // P // P // 256 * 256, 256)
        for frac, tag in ((0.01, "sparse frontier (1% of edges)"),
                          (0.30, "dense-ish frontier (30%)")):
            fe = int(nnz * frac)
            out.append(f"\n## rmat{scale} ef{ef}, P={P}, {tag}\n\n"
                       f"n = {n:,}, nnz = {nnz:,}, frontier edges = {fe:,}, "
                       f"pair_cap = {pair_cap:,}\n\n"
                       + acc.report(n, nnz, P, pair_cap, fe))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="comm_report", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=None,
                    help="write the report here instead of printing it")
    args = ap.parse_args(argv)
    text = HEADER + "\n".join(sections()) + "\n"
    if args.out is None:
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
