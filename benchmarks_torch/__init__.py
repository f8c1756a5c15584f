"""The paper-figure harnesses on the PyTorch port (`repro_torch`), one module
per figure of `benchmarks/`, with the same methods, grids and CSV rows.
They run on the card unless a `main(device="cpu")` asks for the host."""
