"""Speculative-decode plane of the port (``src/repro/spec/``): draft k
tokens cheaply, verify them in ONE k+1-token target forward, accept by
rejection sampling. Distribution-exact, so Proposition 1 survives; greedy
spec is token-identical to non-spec.

* ``verify.py``  — accept/reject, leftover resample, bonus draw, and the
  device-side commit walk;
* ``draft.py``   — the draft providers: prompt lookup and the resident
  draft model (``ModelDraft``, shaped by ``draft_config``);
* ``sampler.py`` — the group-at-a-time ``SpecSampler``, the dense verify
  step it shares with the slot engine (``core/cbatch.py``), and the
  block-packing and truncation helpers every spec engine uses.
"""
from repro_torch.spec.draft import (ModelDraft, PromptLookupDraft,
                                    draft_config, make_draft_provider)
from repro_torch.spec.sampler import (SpecSampler, dense_verify_step,
                                      pack_row_block, truncate_commit)
from repro_torch.spec.verify import assemble_commit, commit_block, verify_block

__all__ = ["verify_block", "commit_block", "assemble_commit",
           "PromptLookupDraft", "ModelDraft", "draft_config",
           "make_draft_provider", "SpecSampler", "dense_verify_step",
           "pack_row_block", "truncate_commit"]
