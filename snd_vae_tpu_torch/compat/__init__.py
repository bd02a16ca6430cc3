"""Weights from outside the port: the TF reference's variables
(``tf_import``).  A JAX package checkpoint comes in through
``params.load_flax_npz``."""

from .tf_import import (
    map_reference_variables, map_reference_variables_joint, state_dict_from_tf_variables,
)

__all__ = ["map_reference_variables", "map_reference_variables_joint",
           "state_dict_from_tf_variables"]
