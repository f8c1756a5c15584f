"""Run every ported paper-figure harness and the serving sweep and print
CSV (figure,setting,metric,value).  The port of `benchmarks/run.py`, in its
order, without its kernel and sharded benchmarks (not ported yet: ROADMAP
queue 1, items 8 and 9; the kernels are timed by chip_smoke.py).

  PYTHONPATH=src python -m benchmarks_torch.run                   # quick, on the card
  BENCH_MODEL=paper PYTHONPATH=src python -m benchmarks_torch.run # the paper's backbones
  BENCH_QUICK=0 PYTHONPATH=src python -m benchmarks_torch.run     # full mode
"""
from __future__ import annotations

import time


def main(device=None) -> None:
    from benchmarks_torch import (fig2_comm_efficiency, fig3_async_bandwidth,
                                  fig4_freezing, fig5_heterogeneity,
                                  fig6_system_het, fig7_privacy,
                                  serving_bench, table1_partitions)
    t0 = time.time()
    print("figure,setting,metric,value")
    table1_partitions.main()
    serving_bench.main(device=device)
    fig2_comm_efficiency.main(device=device)
    fig3_async_bandwidth.main(device=device)
    fig4_freezing.main(device=device)
    fig5_heterogeneity.main(device=device)
    fig6_system_het.main(device=device)
    fig7_privacy.main(device=device)
    print(f"\n[benchmarks done in {time.time() - t0:.0f}s]")


if __name__ == "__main__":
    main()
