"""Work of one PACOH-SVGD meta-training step at a cell's shapes, whichever
kernel carries it: B2's count for tasks of N <= 8 points, B10's above."""

from benchmark.work import fused_svgd, fused_svgd_bign


def flops_per_step(s):
    return (fused_svgd if s["n"] <= 8 else fused_svgd_bign).flops_per_step(s)
