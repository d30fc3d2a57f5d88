"""Data integrity for the port's artifacts (port of sheep_tpu/integrity).

  errors.py    the IntegrityError taxonomy (ChecksumMismatch,
               MalformedArtifact, IncompatibleMerge)
  sidecar.py   ``.sum`` sidecar checksums sealed beside every artifact and
               verified on read under a strict/repair/trust policy (env
               ``SHEEP_INTEGRITY``)
  fsck.py      verify any artifact or trial directory (``cli/fsck.py``);
               artifacts of unported modules are reported as failures

The fast forest oracle is ``core.validate.check_forest_fast``.
"""

from .errors import (ChecksumMismatch, IncompatibleMerge, IntegrityError,
                     MalformedArtifact)
from .sidecar import (DEFAULT_ALGO, POLICIES, checksummed_write, read_sidecar,
                      resolve_policy, sealed_write, sidecar_path,
                      verify_bytes, verify_file, write_sidecar)

__all__ = [
    "ChecksumMismatch",
    "DEFAULT_ALGO",
    "IncompatibleMerge",
    "IntegrityError",
    "MalformedArtifact",
    "POLICIES",
    "checksummed_write",
    "read_sidecar",
    "resolve_policy",
    "sealed_write",
    "sidecar_path",
    "verify_bytes",
    "verify_file",
    "write_sidecar",
]
