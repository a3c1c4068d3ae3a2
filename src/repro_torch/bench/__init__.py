"""repro_torch.bench — the port's benchmarks, run on the card.

kernels: every hand-written kernel against its plain version and a library
         yardstick, with its bound (``python -m repro_torch.bench.kernels``);
common:  the card's rates, the bound, the kernel timer and CSV output.
"""
