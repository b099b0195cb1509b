"""Kerberos ticket acquisition for secured HDFS data access (the port's
copy of shifu_tpu/launcher/security.py).

Successor of the reference client's delegation-token fetch
(TensorflowClient.java:481-502 obtained HDFS delegation tokens and shipped
them into every YARN container).  Under SPMD there are no containers to
ship credentials to: the single program authenticates once, before any
`hdfs://` I/O, via `kinit` against the configured principal/keytab
(`shifu.security.kerberos.{principal,keytab}`); libhdfs (pyarrow.fs
HadoopFileSystem, the remote half of data/fsio.py) then reads the ambient
ticket cache.
With no principal configured this is a no-op and any pre-existing ticket
cache is used as-is.
"""

from __future__ import annotations

import logging
import shutil
import subprocess

logger = logging.getLogger(__name__)


class KerberosError(RuntimeError):
    """kinit was required but unavailable or failed."""


def ensure_kerberos_ticket(principal: str = "", keytab: str = "") -> bool:
    """Acquire a ticket if a principal is configured.

    Returns True when a kinit ran successfully, False for the no-op case.
    Raises KerberosError when a principal is configured but the ticket
    cannot be obtained (missing kinit, missing keytab, kinit failure) —
    failing fast here beats an opaque libhdfs GSSAPI error mid-read.
    """
    principal = principal or ""
    keytab = keytab or ""
    if not principal:
        if keytab:
            raise KerberosError(
                f"shifu.security.kerberos.keytab={keytab!r} is configured "
                "without shifu.security.kerberos.principal — set the "
                "principal (misconfiguration would otherwise surface as an "
                "opaque GSSAPI failure mid-read)")
        return False
    if not keytab:
        # password-prompt kinit cannot work in a batch job (no tty to
        # prompt on); require the keytab rather than hang on stdin
        raise KerberosError(
            f"shifu.security.kerberos.principal={principal!r} is configured "
            "without shifu.security.kerberos.keytab — headless jobs need a "
            "keytab (interactive password entry is not supported)")
    kinit = shutil.which("kinit")
    if kinit is None:
        raise KerberosError(
            f"shifu.security.kerberos.principal={principal!r} is configured "
            "but no `kinit` binary is on PATH")
    cmd = [kinit, "-kt", keytab, principal]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120, stdin=subprocess.DEVNULL)
    except subprocess.TimeoutExpired as e:
        raise KerberosError(
            f"kinit timed out after 120s (KDC unreachable?): {' '.join(cmd)}"
        ) from e
    if proc.returncode != 0:
        raise KerberosError(
            f"kinit failed (rc={proc.returncode}): "
            f"{proc.stderr.strip() or proc.stdout.strip()}")
    logger.info("kerberos: ticket acquired for %s", principal)
    return True
