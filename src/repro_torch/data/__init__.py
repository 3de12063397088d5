from repro_torch.data.synthetic import (SyntheticSpec, auto_lsh_params,
                                        make_blobs_with_noise)

__all__ = ["SyntheticSpec", "auto_lsh_params", "make_blobs_with_noise"]
