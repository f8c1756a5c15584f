"""Synthetic federated tasks, client partitions and round sampling: the
port's own numpy copy of `src/repro/data/` (same arrays, bit for bit,
from the same seed)."""
from repro_torch.data.datasets import (TASKS, FederatedTask, make_synth_flair,
                                       make_synth_image, make_synth_reddit,
                                       make_synth_text)
from repro_torch.data.partition import (dirichlet_partition,
                                        label_heterogeneity,
                                        natural_partition)
from repro_torch.data.pipeline import eval_batches, sample_round

__all__ = ["TASKS", "FederatedTask", "dirichlet_partition", "eval_batches",
           "label_heterogeneity", "make_synth_flair", "make_synth_image",
           "make_synth_reddit", "make_synth_text", "natural_partition",
           "sample_round"]
