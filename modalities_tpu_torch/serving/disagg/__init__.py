"""Disaggregated prefill/decode serving, the port of
modalities_tpu/serving/disagg/.

A fleet splits into a PREFILL tier (engines with `role="prefill"`: the
packed prefill to the first token, no decode forward) and a DECODE tier
(engines with `role="decode"`: imports and the decode forward only). The
seam is the versioned KV handoff record (handoff.py). The record changes
where work runs, never the tokens: greedy output is bitwise the combined
paged engine's.

- handoff.py: HandoffRecord, its digest and its wire (JSON) form
- pair.py: one prefill and one decode engine in one process
- router.py: DisaggRouter, the two legs behind ONE SSE answer, with the
  decode leg's failover through a fresh prefill
- component.py: the `inference_component` variant "disagg"
"""

from modalities_tpu_torch.serving.disagg.handoff import HANDOFF_VERSION, HandoffRecord, HandoffRejected  # noqa: F401
