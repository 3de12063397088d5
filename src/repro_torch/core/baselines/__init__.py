from repro_torch.core.baselines.sea import sea_detect  # noqa: F401
from repro_torch.core.baselines.ap import affinity_propagation  # noqa: F401
from repro_torch.core.baselines.kmeans import kmeans  # noqa: F401
from repro_torch.core.baselines.spectral import (  # noqa: F401
    spectral_clustering)
from repro_torch.core.baselines.meanshift import mean_shift  # noqa: F401
