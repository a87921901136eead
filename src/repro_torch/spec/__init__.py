"""Speculative-decode plane of the port (``src/repro/spec/``): draft k
tokens cheaply, verify them in ONE k+1-token target forward through the
paged-verify kernel, accept by rejection sampling. Distribution-exact, so
Proposition 1 survives; greedy spec is token-identical to non-spec.

* ``verify.py``  — accept/reject, leftover resample, bonus draw, and the
  device-side commit walk;
* ``draft.py``   — the prompt-lookup draft provider;
* ``sampler.py`` — the block-packing and truncation helpers the paged
  engine (``core/paged.py``) uses.
"""
from repro_torch.spec.draft import PromptLookupDraft, make_draft_provider
from repro_torch.spec.sampler import pack_row_block, truncate_commit
from repro_torch.spec.verify import assemble_commit, commit_block, verify_block

__all__ = ["verify_block", "commit_block", "assemble_commit",
           "PromptLookupDraft", "make_draft_provider",
           "pack_row_block", "truncate_commit"]
