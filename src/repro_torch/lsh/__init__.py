from repro_torch.lsh.pstable import (LSHParams, LSHTables, build_lsh,
                                     hash_points, query_batch)

__all__ = ["LSHParams", "LSHTables", "build_lsh", "hash_points",
           "query_batch"]
