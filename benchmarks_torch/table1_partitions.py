"""Table 1: partition statistics of the four federated tasks (no model
runs).  The port of `benchmarks/table1_partitions.py`."""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import emit, get_task, row
from repro_torch.data.partition import label_heterogeneity


def main():
    rows = []
    for name in ("synth_image", "synth_text", "synth_reddit", "synth_flair"):
        task = get_task(name)
        sizes = [len(p) for p in task.parts]
        rows.append(row("table1", name, "n_clients", task.n_clients))
        rows.append(row("table1", name, "n_examples",
                        int(len(next(iter(task.data.values()))))))
        rows.append(row("table1", name, "mean_client_size", float(np.mean(sizes))))
        rows.append(row("table1", name, "n_classes", task.n_classes))
        if "labels" in task.data:
            rows.append(row("table1", name, "label_skew",
                            label_heterogeneity(task.parts, task.data["labels"])))
    return emit(rows, "Table 1: partition statistics")


if __name__ == "__main__":
    main()
