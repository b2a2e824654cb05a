"""Run configurations of the port: the LM zoo's architecture schema and
registry (``ArchConfig``, ``register``, ``get_config``, ``list_configs``;
``archs`` imports the ten published architectures; ``kimi_k2_instruct``
is the port's own, outside the mirrored registry), the paper's b-bit
deployment (``rcv1_bbit``) and the OPH serving and streaming one
(``rcv1_oph``)."""
from repro_torch.configs.base import (ArchConfig, get_config, list_configs,
                                      register)

__all__ = ["ArchConfig", "register", "get_config", "list_configs"]
