"""repro_torch.launch — the continuous-batching engine and the serve CLI."""
