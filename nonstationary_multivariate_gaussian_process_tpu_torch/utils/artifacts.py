"""Manifest-based artifact store: the fleet's checkpoint/resume layer.

A copy of the JAX package's ``utils/artifacts.py`` (numpy only), kept here so
the port imports nothing of that package.  The on-disk format is the same
(``<model>__<dataset>__<subject>__<stage>.npz`` plus ``manifest.json``), so a
store written by either package loads unchanged in the other.

The store replaces the reference's pickle-tree convention (``MAP.dat``,
``HMC_sample.pickle``, ``empirical_est.pickle`` per subject directory,
e.g. ``Nonseparable_model.py:186-210``) and its post-hoc completeness scanners
(``tool/check_NMGP_MAP_results.py``) with arrays stored as ``.npz`` keyed by
``(model, dataset, subject, stage)`` and a JSON manifest recording what
completed.
"""

from __future__ import annotations

import json
import os
import tempfile
import numpy as np


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")

    # -- manifest ----------------------------------------------------------

    def _load_manifest(self) -> dict:
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                return json.load(f)
        return {}

    def _write_manifest(self, manifest: dict) -> None:
        # atomic write so a crash never corrupts the manifest
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".manifest")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, self._manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @staticmethod
    def key(model: str, dataset: str, subject, stage: str) -> str:
        return f"{model}__{dataset}__{subject}__{stage}"

    def path(self, key: str) -> str:
        return os.path.join(self.root, key + ".npz")

    # -- save / load -------------------------------------------------------

    def save(self, key: str, **arrays) -> None:
        np.savez(self.path(key), **{k: np.asarray(v) for k, v in arrays.items()})
        manifest = self._load_manifest()
        manifest[key] = {"arrays": sorted(arrays)}
        self._write_manifest(manifest)

    def load(self, key: str) -> dict:
        with np.load(self.path(key)) as z:
            return {k: z[k] for k in z.files}

    def exists(self, key: str) -> bool:
        return key in self._load_manifest() and os.path.exists(self.path(key))
