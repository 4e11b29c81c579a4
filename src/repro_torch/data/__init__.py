from repro_torch.data.pipeline import (Prefetcher, SyntheticLM,  # noqa: F401
                                       to_device)
