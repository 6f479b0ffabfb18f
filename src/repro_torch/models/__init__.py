from repro_torch.models.model import (Model, build_model, params_from_jax,  # noqa: F401
                                      params_to_jax)
