"""The integrity-error taxonomy: every way an artifact can lie to us.

All types subclass :class:`IntegrityError`, which itself subclasses
``ValueError`` so pre-existing callers (and tests) that catch ValueError on
a corrupt read keep working.  The split matters operationally:

  ChecksumMismatch    the bytes changed after the writer sealed them — a
                      bit-flip, torn copy, or tampering.  The artifact may
                      still PARSE; only the sidecar knows it is wrong.
  MalformedArtifact   the bytes do not parse as the format claims —
                      truncated records, non-integer tokens, a header that
                      lies about the payload.  Detectable without a sidecar.
  IncompatibleMerge   two individually-valid artifacts that must not be
                      combined (different n, different input signature).

Policy modes (see integrity.sidecar): "strict" raises on any of these,
"repair" salvages what provably survives and warns, "trust" skips the
checksum work entirely (structural parse errors still raise — garbage that
cannot be parsed is never silently accepted in any mode).
"""

from __future__ import annotations


class IntegrityError(ValueError):
    """Base of every data-integrity failure in sheep_tpu_torch."""


class ChecksumMismatch(IntegrityError):
    """Artifact bytes disagree with their sidecar checksum."""


class MalformedArtifact(IntegrityError):
    """Artifact bytes do not parse as the format they claim to be."""


class IncompatibleMerge(IntegrityError):
    """Two valid artifacts that cannot be combined (n / signature clash)."""
