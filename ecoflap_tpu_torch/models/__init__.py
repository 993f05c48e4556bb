"""The port's model families; the zoo's public API is exported here."""

from ecoflap_tpu_torch.models.zoo import (  # noqa: F401
    ModelBundle,
    load_model,
    load_model_and_preprocess,
)
