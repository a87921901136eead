from repro_torch.models.model import (forward, forward_hidden, init,
                                      init_caches, init_paged_caches, logits,
                                      token_logprobs)

__all__ = ["forward", "forward_hidden", "init", "init_caches",
           "init_paged_caches", "logits", "token_logprobs"]
