"""The LM half of the port: models, after the reference's ``repro.models``."""

from repro_torch.models.api import Model, get_model  # noqa: F401
from repro_torch.models.params import params_from_numpy  # noqa: F401
