"""Remote sync of a run's log dir, and remote reads for `--resume latest`.

Counterpart of `daclip_tpu/utils/file_utils.py:25-160` (reference
da-clip/src/training/file_utils.py:10-75):
  * protocols: 's3' runs `aws s3 sync` as the reference does, 'gs' runs
    `gsutil -m rsync -r`, 'fsspec' copies through fsspec's mappers with the
    same skip-if-same-size rule (fsspec is imported in the call);
  * `epoch_latest` files are skipped (they change mid-copy);
  * the periodic sync runs in a daemon thread that syncs once more when it
    is stopped.
"""
from __future__ import annotations

import logging
import os
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    result = subprocess.run(
        ["aws", "s3", "sync", local_dir, remote_dir, "--exclude", "*epoch_latest*"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if result.returncode != 0:
        log.error("Failed to sync with S3 bucket: %s",
                  result.stderr.decode("utf-8", "replace"))
        return False
    log.info("Successfully synced with S3 bucket")
    return True


def remote_sync_gs(local_dir: str, remote_dir: str) -> bool:
    result = subprocess.run(
        ["gsutil", "-m", "rsync", "-r", "-x", ".*epoch_latest.*", local_dir, remote_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if result.returncode != 0:
        log.error("Failed to sync with GCS bucket: %s",
                  result.stderr.decode("utf-8", "replace"))
        return False
    log.info("Successfully synced with GCS bucket")
    return True


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    import fsspec

    a = fsspec.get_mapper(local_dir)
    b = fsspec.get_mapper(remote_dir)
    for k in a:
        if "epoch_latest" in k:
            continue
        try:
            if k in b and len(a[k]) == len(b[k]):
                continue
            b[k] = a[k]
            log.info("Synced %s", k)
        except Exception as e:  # noqa: BLE001 — a failed sync must not stop training
            log.warning("Error during remote sync for %s: %s", k, e)
            return False
    return True


def remote_sync(local_dir: str, remote_dir: str, protocol: str) -> bool:
    log.info("Starting remote sync: %s -> %s", local_dir, remote_dir)
    if protocol == "s3":
        return remote_sync_s3(local_dir, remote_dir)
    if protocol == "gs":
        return remote_sync_gs(local_dir, remote_dir)
    if protocol == "fsspec":
        return remote_sync_fsspec(local_dir, remote_dir)
    log.error("Remote protocol %r not known (s3 | gs | fsspec)", protocol)
    return False


class SyncThread(threading.Thread):
    """Sync every `sync_every` seconds (reference start_sync_process,
    file_utils.py:58-60); a daemon thread, so it never blocks shutdown."""

    def __init__(self, sync_every: float, local_dir: str, remote_dir: str, protocol: str):
        super().__init__(daemon=True, name="remote-sync")
        self.sync_every = sync_every
        self.local_dir = local_dir
        self.remote_dir = remote_dir
        self.protocol = protocol
        self._halt = threading.Event()  # not `_stop`: Thread.join calls a method of that name

    def run(self):
        while not self._halt.wait(self.sync_every):
            remote_sync(self.local_dir, self.remote_dir, self.protocol)

    def stop(self, final_sync: bool = True):
        """End the loop, wait for a sync in flight, then sync once more."""
        self._halt.set()
        if self.is_alive():
            self.join()
        if final_sync:
            return remote_sync(self.local_dir, self.remote_dir, self.protocol)
        return True


def start_sync_process(sync_every: float, local_dir: str, remote_dir: str,
                       protocol: str) -> SyncThread:
    return SyncThread(sync_every, local_dir, remote_dir, protocol)


def check_exists(file_path: str) -> bool:
    if "://" not in file_path:
        return os.path.exists(file_path)
    import fsspec

    try:
        with fsspec.open(file_path):
            pass
    except (FileNotFoundError, OSError):
        return False
    return True


def list_remote_dir(path: str):
    """The sorted entries of a local or remote (s3://, gs://, …) directory,
    [] when it is missing (reference get_latest_checkpoint's remote branch,
    main.py:131-163)."""
    if "://" not in path:
        return sorted(os.listdir(path)) if os.path.isdir(path) else []
    import fsspec

    fs, rel = fsspec.core.url_to_fs(path)
    try:
        return sorted(os.path.basename(p.rstrip("/")) for p in fs.ls(rel))
    except (FileNotFoundError, OSError):
        return []


def download_remote_dir(remote_dir: str, local_dir: str) -> Optional[str]:
    """Mirror a remote checkpoint directory into `local_dir` for a resume;
    returns `local_dir`, or None when the copy failed."""
    os.makedirs(local_dir, exist_ok=True)
    if remote_dir.startswith("s3://"):
        r = subprocess.run(["aws", "s3", "sync", remote_dir, local_dir],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        return local_dir if r.returncode == 0 else None
    if remote_dir.startswith("gs://"):
        r = subprocess.run(["gsutil", "-m", "rsync", "-r", remote_dir, local_dir],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        return local_dir if r.returncode == 0 else None
    import fsspec

    a = fsspec.get_mapper(remote_dir)
    b = fsspec.get_mapper(local_dir)
    try:
        for k in a:
            b[k] = a[k]
    except (FileNotFoundError, OSError):
        return None
    return local_dir
