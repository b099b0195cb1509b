"""The artifact's digest manifest (port of `write_sync_manifest` and
`read_sync_manifest` of shifu_tpu/runtime/fleet.py; the rest of the fleet
is ROADMAP.md queue A item (e)7).

`sync_manifest.json` holds a blake2b-16 digest of every other file of an
export directory.  A fleet host verifies its pull of the artifact against
it before it swaps the model in; the JAX package's `read_sync_manifest`
and its `sync_artifact` read the port's manifest the same way.  Local or
remote (hdfs:// gs:// s3:// mock://) directories, through `data/fsio`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from ..data import fsio

MANIFEST_FILE = "sync_manifest.json"


def write_sync_manifest(export_dir: str) -> str:
    """Write `<export_dir>/sync_manifest.json`: a blake2b-16 digest per
    file, the manifest itself excluded; returns its path.  Raises on any
    failure (unlike the JAX exporter, which swallows it)."""
    prefix = (export_dir.rstrip("/") + "/" if fsio.is_remote(export_dir)
              else export_dir.rstrip(os.sep) + os.sep)
    files = {}
    for path, _size in fsio.walk_files(export_dir):
        rel = path[len(prefix):] if path.startswith(prefix) else path
        if rel == MANIFEST_FILE or rel.endswith("/" + MANIFEST_FILE):
            continue
        digest = hashlib.blake2b(fsio.read_bytes(path),
                                 digest_size=16).hexdigest()
        files[rel.replace(os.sep, "/")] = digest
    manifest = {"algo": "blake2b-16", "files": files}
    path = fsio.join(export_dir, MANIFEST_FILE)
    fsio.write_bytes_atomic(path, json.dumps(manifest, indent=2,
                                             sort_keys=True).encode())
    return path


def read_sync_manifest(export_dir: str) -> Optional[dict]:
    """The manifest of `export_dir`, or None when it is missing or
    unreadable."""
    try:
        raw = fsio.read_bytes(fsio.join(export_dir, MANIFEST_FILE))
        rec = json.loads(raw.decode())
        if isinstance(rec, dict) and isinstance(rec.get("files"), dict):
            return rec
    except Exception:
        pass
    return None
