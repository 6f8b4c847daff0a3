"""core layer of the PyTorch port (see the package docstring).

The LoadAware plugin's library entry points are exported here, as the JAX
package's ``core`` exports them."""

from koordinator_tpu_torch.core.config import LoadAwareArgs
from koordinator_tpu_torch.core.loadaware import (
    LoadAwareNodeArrays,
    LoadAwarePodArrays,
    loadaware_filter,
    loadaware_score,
    loadaware_score_and_filter,
)

__all__ = [
    "LoadAwareArgs",
    "LoadAwarePodArrays",
    "LoadAwareNodeArrays",
    "loadaware_score",
    "loadaware_filter",
    "loadaware_score_and_filter",
]
