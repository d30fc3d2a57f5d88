"""The build planner (port of sheep_tpu/plan: ``plan_build``, the prior
store it reads, the distext job's leg and transport decisions, and the
serve tier's re-sequence pricing).

``plan_build`` resolves one build's plan — rung order, native thread
count, ext/spill block size, handoff windows — folding the governor's
analytic prices (resources/governor.py) with measured priors learned from
past traces (plan/priors.py).  Every ``SHEEP_*`` knob is an *override*
recorded in the plan with its provenance (default | priced | learned |
forced).  ``plan_reseq`` prices a serve store's re-sequence rebuild,
learning the fold's throughput (``fold_bps``) from ``reseq.fold`` spans.
"""

from .model import (DEFAULT_LADDER, PROV_DEFAULT, PROV_FORCED,
                    PROV_LEARNED, PROV_PRICED, RESEQ_FOLD_BPS,
                    RESEQ_HORIZON_ENV, RESEQ_PIN_ENV, WORKER_TRANSPORT_ENV,
                    Decision, Plan, available_rungs, plan_build,
                    plan_distext_legs, plan_reseq, plan_transport)
from .priors import (MIN_CORRECT_SAMPLES, PRIORS_ENV, PriorStore, fold_bps,
                     host_fingerprint, mem_ratio, prior_key, scale_bucket)

__all__ = [
    "DEFAULT_LADDER",
    "Decision",
    "MIN_CORRECT_SAMPLES",
    "PRIORS_ENV",
    "PROV_DEFAULT",
    "PROV_FORCED",
    "PROV_LEARNED",
    "PROV_PRICED",
    "Plan",
    "PriorStore",
    "RESEQ_FOLD_BPS",
    "RESEQ_HORIZON_ENV",
    "RESEQ_PIN_ENV",
    "WORKER_TRANSPORT_ENV",
    "available_rungs",
    "fold_bps",
    "host_fingerprint",
    "mem_ratio",
    "plan_build",
    "plan_distext_legs",
    "plan_reseq",
    "plan_transport",
    "prior_key",
    "scale_bucket",
]
