from repro_torch.checkpoint.async_manager import AsyncCheckpointManager  # noqa: F401,E501
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
