"""The federated round and its transport: sparsity, quantization, the
Top-K selector registry, transport stages, byte accounting, strategies,
and the round function (`fedround.py`).  Mirrors `src/repro/core/`."""
