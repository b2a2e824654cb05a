"""Solvers: TRON (LIBLINEAR's trust-region Newton method), SGD and AdamW,
learning-rate schedules and Polyak tail averaging, and the narrow AdamW
moments (counterpart of ``repro/optim``, the same exports)."""
from repro_torch.optim.averaging import (average_or_none, init_average,
                                         polyak_update)
from repro_torch.optim.optimizers import (AdamWConfig, Optimizer, adamw,
                                          make_optimizer, sgd)
from repro_torch.optim.quantized_state import (QuantizedArray, dequantize,
                                               maybe_dequantize,
                                               maybe_quantize, quantize)
from repro_torch.optim.schedules import (constant, inverse_sqrt, make,
                                         warmup_cosine)
from repro_torch.optim.tron import TronResult, tron_minimize

__all__ = [
    "Optimizer", "AdamWConfig", "sgd", "adamw", "make_optimizer",
    "constant", "warmup_cosine", "inverse_sqrt", "make",
    "tron_minimize", "TronResult",
    "init_average", "polyak_update", "average_or_none",
    "QuantizedArray", "quantize", "dequantize", "maybe_quantize",
    "maybe_dequantize",
]
