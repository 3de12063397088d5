from repro_torch.data.synthetic import (SyntheticSpec, auto_lsh_params,
                                        make_blobs_with_noise,
                                        make_regime_dataset)

__all__ = ["SyntheticSpec", "auto_lsh_params", "make_blobs_with_noise",
           "make_regime_dataset"]
