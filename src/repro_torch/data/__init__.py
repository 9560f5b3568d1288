from .synthetic import SyntheticLM, TokenBatch, eval_batch
from .conditioned import gen_dot, gen_linear_system, residual_exact
