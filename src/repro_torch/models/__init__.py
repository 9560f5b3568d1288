from .config import ModelConfig, check_family
from .convert import params_from_numpy, params_to_numpy
from .transformer import (Transformer, decode_step, forward, init, init_cache,
                          prefill)
