from .store import CheckpointStore
