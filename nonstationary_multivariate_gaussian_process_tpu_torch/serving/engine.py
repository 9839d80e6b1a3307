"""Serving layer: predict endpoints over the artifact store.

Counterpart of the JAX package's ``serving/engine.py`` for the dense models
``lmc``, ``snmgp``, ``gnmgp`` and ``gnmgp_hetero`` and the sparse tiers
``gnmgp_sparse``, ``gnmgp_hetero_sparse``, ``snmgp_sparse`` and
``lmc_sparse`` (their ops rebuilt from the inducing inputs ``z`` and the
approximation the ``map`` artifact carries), with its two modes:
``mode="map"`` (plug-in prediction) and ``mode="sample"`` (prediction over
the stored HMC chain).  As in JAX, ``gnmgp_hetero_sparse`` serves
``mode="map"`` only: a sample request for it raises ``ValueError``.
``PredictEngine(root)`` stands up from an artifact root alone: the
conditioning data (``data`` stage) next to the MAP vector (``map``) and the
chain (``hmc``), as ``workflows.run_subject`` of either package writes them.

Requests are padded to a small set of grid buckets (repeating the last point)
and cropped, as in the JAX engine, so that a request sees the same shapes
there and here.  The port runs eagerly: there is nothing to compile.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import settings
from ..convert import subject_from_store
from ..predict import gnmgp as pred_gnmgp
from ..predict import gnmgp_hetero as pred_gnmgp_hetero
from ..predict import gnmgp_sparse as pred_gnmgp_sparse
from ..predict import lmc as pred_lmc
from ..predict import lmc_sparse as pred_lmc_sparse
from ..predict import snmgp as pred_snmgp
from ..predict import snmgp_sparse as pred_snmgp_sparse
from ..utils.artifacts import ArtifactStore

_PRED = {"lmc": pred_lmc, "snmgp": pred_snmgp, "gnmgp": pred_gnmgp, "gnmgp_hetero": pred_gnmgp_hetero,
         "gnmgp_sparse": pred_gnmgp_sparse, "gnmgp_hetero_sparse": pred_gnmgp_sparse,
         "snmgp_sparse": pred_snmgp_sparse, "lmc_sparse": pred_lmc_sparse}
MODELS = tuple(_PRED)
#: The sparse models: their predictors take the subject's ops.
SPARSE = ("gnmgp_sparse", "gnmgp_hetero_sparse", "snmgp_sparse", "lmc_sparse")
#: The models that serve ``mode="map"`` only (JAX's engine has no chain
#: predictor for them).
MAP_ONLY = ("gnmgp_hetero_sparse",)
MODES = ("map", "sample")

GRID_BUCKETS = (32, 64, 128, 256, 512, 1024)
#: Request sizes that :meth:`PredictEngine.warm` runs for each subject shape.
WARM_GRID_SIZES = (64, 256)


def _bucket(g: int, buckets=GRID_BUCKETS) -> int:
    for b in buckets:
        if g <= b:
            return b
    return -(-g // buckets[-1]) * buckets[-1]


class PredictEngine:
    """Loads fitted subjects from an artifact store and serves predictions.

    ``device`` defaults to ``cuda`` and raises when there is none; pass
    ``device="cpu"`` to serve on the CPU.  ``mode="sample"`` draws from the
    engine's own ``torch.Generator`` on ``device``, seeded by ``seed``.
    """

    def __init__(
        self,
        root: str,
        model: str = "gnmgp",
        dataset: str = "sim",
        seed: int = 0,
        device=None,
        dtype=None,
    ):
        if model not in MODELS:
            raise ValueError(f"unknown model {model!r} (want one of {MODELS})")
        self.device = settings.resolve_device(device)
        self.dtype = dtype or settings.dtype
        self.store = ArtifactStore(root)
        self.model = model
        self._pred = _PRED[model]
        self.dataset = dataset
        self._subjects: dict[str, dict] = {}
        self._generator = torch.Generator(self.device).manual_seed(seed)
        # serialize device work (loading a subject onto the device, predicting,
        # the kernels' launch counts) and the subject cache across the HTTP
        # server's threads
        self._lock = threading.Lock()

    # -- catalog -----------------------------------------------------------

    def subject_ids(self) -> list[str]:
        """Subjects with both conditioning data and a fitted MAP in the store."""
        manifest = self.store._load_manifest()
        prefix = f"{self.model}__{self.dataset}__"
        sids = []
        for key in manifest:
            if key.startswith(prefix) and key.endswith("__map"):
                sid = key[len(prefix) : -len("__map")]
                if self.store.exists(ArtifactStore.key(self.model, self.dataset, sid, "data")):
                    sids.append(sid)
        return sorted(sids)

    def _load(self, sid: str) -> dict:
        """The subject's record, loaded onto the device at first use.  Call
        with ``self._lock`` held."""
        if sid not in self._subjects:
            subj = subject_from_store(
                self.store.root, sid, self.model, self.dataset, self.device, self.dtype
            )
            rec = {"data": subj.data, "vec": subj.vec}
            if self.model in SPARSE:
                from ..models import gnmgp_sparse, lmc_sparse, snmgp_sparse

                make_ops = {"gnmgp_sparse": gnmgp_sparse.make_ops, "gnmgp_hetero_sparse": gnmgp_sparse.make_ops_hetero,
                            "snmgp_sparse": snmgp_sparse.make_ops, "lmc_sparse": lmc_sparse.make_ops}[self.model]
                map_art = self.store.load(ArtifactStore.key(self.model, self.dataset, sid, "map"))
                if "z" not in map_art:
                    raise KeyError(f"subject {sid!r}: sparse artifacts need the inducing inputs ('z' in the map "
                                   "stage); refit with the current run_subject")
                z = torch.as_tensor(map_art["z"], dtype=self.dtype, device=self.device)
                rec["ops"] = make_ops(subj.data.x, z)
                rec["approx"] = str(map_art.get("approx", "fitc"))
            hmc = ArtifactStore.key(self.model, self.dataset, sid, "hmc")
            if self.store.exists(hmc):
                rec["chain"] = torch.as_tensor(
                    self.store.load(hmc)["samples"], dtype=self.dtype, device=self.device
                )
            self._subjects[sid] = rec
        return self._subjects[sid]

    # -- endpoints ----------------------------------------------------------

    def predict(self, sid: str, x_star, mode: str = "map", n_sample: int = 100) -> dict:
        """Predict at arbitrary inputs ``x_star`` for a fitted subject.

        Pads the request to the next grid bucket (repeating the last point),
        then crops.  Returns plain-numpy ``{"mean", "std", "lower", "upper"}``
        (G, M): the plug-in mean and ±1.96σ bands for ``mode="map"``; for
        ``mode="sample"`` the mean, std and 2.5/97.5 percentiles over y
        drawn at each of the chain's last ``n_sample`` draws.
        """
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r} (want 'map' or 'sample')")
        xs = np.atleast_1d(np.asarray(x_star, float))
        if xs.ndim != 1:
            raise ValueError(f"x_star must be 1-D, got shape {xs.shape}")
        g = xs.shape[0]
        grid = np.concatenate([xs, np.full((_bucket(g) - g,), xs[-1])])
        with self._lock:
            rec = self._load(sid)
            args, kw = self._pred_args(rec, grid)
            if mode == "sample":
                if self.model in MAP_ONLY:
                    raise ValueError(f"model {self.model!r} serves mode='map' only")
                if "chain" not in rec:
                    raise KeyError(f"subject {sid!r} has no stored HMC chain")
                draws = self._pred.predict_sample(
                    self._generator, rec["chain"][-int(n_sample):], rec["data"], *args,
                    device=self.device, dtype=self.dtype, **kw,
                )
                if self.model == "lmc":  # the LMC predictor returns (S, G, M)
                    draws = draws.movedim(0, 1)
                draws = draws[:g]  # (G, S, M)
                q = torch.tensor([0.025, 0.975], dtype=draws.dtype, device=draws.device)
                lower, upper = torch.quantile(draws, q, dim=1).cpu().numpy()
                return {
                    "mean": draws.mean(dim=1).cpu().numpy(),
                    "std": draws.std(dim=1, correction=0).cpu().numpy(),
                    "lower": lower,
                    "upper": upper,
                }
            predict_map = self._pred.predict_map_hetero if self.model in MAP_ONLY else self._pred.predict_map
            gp = predict_map(rec["vec"], rec["data"], *args, device=self.device, dtype=self.dtype, **kw)
            pct = gp.percentiles[:g].cpu().numpy()
            return {
                "mean": gp.mean[:g].cpu().numpy(),
                "std": gp.std[:g].cpu().numpy(),
                "lower": pct[:, 0],
                "upper": pct[:, 2],
            }

    def _pred_args(self, rec: dict, grid) -> tuple[tuple, dict]:
        """A predictor's positional arguments after ``data`` (the grid, after
        the subject's ops for a sparse model) and its keywords (a sparse
        model's approximation)."""
        if self.model in SPARSE:
            return (rec["ops"], grid), {"approx": rec["approx"]}
        return (grid,), {}

    def info(self, sid: str) -> dict:
        """Fit metadata for one subject: shapes, stored stages, and the
        persisted sampling record and held-out scores when stored."""
        with self._lock:
            rec = self._load(sid)
        k = lambda stage: ArtifactStore.key(self.model, self.dataset, sid, stage)

        def scalarize(d):
            out = {}
            for kk, v in d.items():
                a = np.asarray(v)
                out[kk] = a.item() if a.ndim == 0 else a.tolist()
            return out

        out = {
            "subject": sid,
            "model": self.model,
            "n": int(rec["data"].x.shape[0]),
            "m": int(rec["data"].y.shape[1]),
            "has_chain": "chain" in rec,
        }
        if "chain" in rec:
            out["n_draws"] = int(rec["chain"].shape[0])
        if self.store.exists(k("sampling")):
            out["sampling"] = scalarize(self.store.load(k("sampling")))
        if self.store.exists(k("scores")):
            out["scores"] = scalarize(self.store.load(k("scores")))
        return out

    def warm(self) -> int:
        """Run one request per (subject shape, bucket of
        :data:`WARM_GRID_SIZES`), so that the device's libraries and
        allocator are set up before traffic arrives.

        Returns the number of (subject-shape, bucket) pairs touched.
        """
        n = 0
        seen = set()
        for sid in self.subject_ids():
            with self._lock:
                shape = tuple(self._load(sid)["data"].y.shape)
            for gs in WARM_GRID_SIZES:
                if (shape, _bucket(gs)) in seen:
                    continue
                seen.add((shape, _bucket(gs)))
                self.predict(sid, np.linspace(0.0, 1.0, gs))
                n += 1
        return n
