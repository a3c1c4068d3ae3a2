from .pipeline import (DataConfig, TokenFileReader, synthetic_batch,
                       synthetic_batches, write_token_file)

__all__ = ["DataConfig", "synthetic_batch", "synthetic_batches",
           "TokenFileReader", "write_token_file"]
