"""Runtime environments: env_vars, working_dir, py_modules.

Analogue of the reference's runtime-env plugins (reference:
python/ray/_private/runtime_env/ — working_dir.py/py_modules.py package a
directory, upload content-addressed to GCS, download+extract on workers;
env_vars land at process spawn). Here packages are content-addressed zips
in the controller KV (ns="pkg"); extraction is per-session cached.
env_vars ride worker spawn (JAX/XLA read env at interpreter start —
TPU_VISIBLE_CHIPS/XLA_FLAGS must be set before import); working_dir and
py_modules are applied inside the actor worker before the user class is
instantiated.
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

MAX_PACKAGE_BYTES = 100 * 1024 * 1024
_uploaded_pkgs: set = set()  # shas this process already shipped
_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}


def package_dir(path: str) -> Tuple[str, bytes]:
    """Zip a directory deterministically -> (sha1, zip_bytes)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"runtime_env path is not a dir: {path}")
    buf = io.BytesIO()
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, path), full))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for rel, full in entries:
            # Fixed timestamp => content-addressed hash is stable.
            info = zipfile.ZipInfo(rel, date_time=(2020, 1, 1, 0, 0, 0))
            with open(full, "rb") as fh:
                z.writestr(info, fh.read())
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path} is {len(blob)} bytes "
            f"(cap {MAX_PACKAGE_BYTES}); exclude large data files")
    return hashlib.sha1(blob).hexdigest(), blob


def upload_packages(cw, runtime_env: Optional[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Driver-side: package working_dir / py_modules into the controller
    KV (content-addressed, deduped); returns the wire-form runtime_env."""
    if not runtime_env:
        return runtime_env
    out = dict(runtime_env)

    def _put(path: str) -> str:
        sha, blob = package_dir(path)
        # Skip the wire transfer entirely when the controller already has
        # this content (process-local cache + a cheap key probe) — re-
        # shipping a 100MB zip per actor would swamp the control plane.
        if sha in _uploaded_pkgs:
            return sha
        existing = cw._run(cw.controller.call(
            "kv_keys", "pkg", sha)).result(30)
        if sha not in existing:
            cw._run(cw.controller.call(
                "kv_put", "pkg", sha, blob, False)).result(120)
        _uploaded_pkgs.add(sha)
        return sha

    if out.get("working_dir"):
        out["working_dir_pkg"] = _put(out.pop("working_dir"))
    if out.get("py_modules"):
        out["py_module_pkgs"] = [
            (_put(p), os.path.basename(os.path.abspath(p)))
            for p in out.pop("py_modules")]
    return out


def apply_in_worker(cw, runtime_env: Optional[Dict[str, Any]]) -> None:
    """Worker-side: download + extract packages, chdir into working_dir,
    put py_modules on sys.path. Called before the actor class is built."""
    if not runtime_env:
        return
    import sys

    def _extract(sha: str) -> str:
        # Atomic: extract to a private temp dir, then rename into place —
        # concurrent workers sharing the session dir must never re-extract
        # over files a running actor is reading.
        target = os.path.join(cw.session_dir, "runtime_envs", sha)
        if os.path.isdir(target):
            return target
        blob = cw._run(cw.controller.call(
            "kv_get", "pkg", sha)).result(120)
        if blob is None:
            raise RuntimeError(f"runtime_env package {sha} missing from KV")
        tmp = f"{target}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            z.extractall(tmp)
        try:
            os.rename(tmp, target)
        except OSError:  # raced: someone else won; use theirs
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
        return target

    if runtime_env.get("working_dir_pkg"):
        wd = _extract(runtime_env["working_dir_pkg"])
        os.chdir(wd)
        if wd not in sys.path:
            sys.path.insert(0, wd)
    for sha, name in runtime_env.get("py_module_pkgs", []):
        root = _extract(sha)
        # The zip holds the MODULE DIRECTORY's contents; expose it under
        # its original name so `import <name>` works.
        pkg_parent = os.path.join(cw.session_dir, "runtime_envs",
                                  f"{sha}-mod")
        os.makedirs(pkg_parent, exist_ok=True)
        link = os.path.join(pkg_parent, name)
        if not os.path.exists(link):
            try:
                os.symlink(root, link)
            except OSError:
                import shutil
                shutil.copytree(root, link, dirs_exist_ok=True)
        if pkg_parent not in sys.path:
            sys.path.insert(0, pkg_parent)
