from .synthetic import SyntheticLM, TokenBatch, eval_batch
