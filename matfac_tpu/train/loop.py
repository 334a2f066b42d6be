"""The training loop: epoch sweep + the exact reference termination
state machine.

Semantics of Model::isTerminateModel (model.cpp:1471-1540), encoded as a
pure host-side state machine (SURVEY.md §7 "exact termination
semantics"):

  * every OBJ_ITER epochs compute objective(train) and RMSE(val);
  * NaN in either -> if lr > 1e-5: restore current state from the best
    snapshot, halve lr, continue; else stop;
  * val RMSE improved -> snapshot best model;
  * >= 100 epochs without improvement -> halve lr (every check, while
    lr > 1e-5);
  * >= CHANCE_ITER (500) epochs without improvement -> stop
    ("NOT CONVERGED");
  * |prevObj - currObj| < EPS -> stop ("converged").

Best-on-validation is what gets checkpointed (modelMF.cpp:135-146).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from matfac_tpu.config import Params
from matfac_tpu.eval.metrics import Evaluator
from matfac_tpu.models.base import MFState
from matfac_tpu.train import checkpoint as ckpt


@dataclasses.dataclass
class EpochLog:
    epoch: int
    objective: float
    val_rmse: float
    train_rmse: float
    lr: float
    seconds: float


@dataclasses.dataclass
class TrainReport:
    state: MFState               # final running state
    best_state: MFState          # best-on-validation snapshot
    best_metric: float   # val RMSE (pointwise loops) or val HR@10 (ranking loops)
    best_iter: int
    stop_reason: str
    history: List[EpochLog]
    # set by train_model: the solver that actually ran (after any
    # budget fallback) and the seconds its construction took (host
    # staging + device upload)
    method: str = ""
    staging_seconds: float = 0.0


class TrainLoop:
    def __init__(self, model, solver, evaluator: Evaluator, params: Params,
                 prefix: Optional[str] = None,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None,
                 log_fn: Callable[[str], None] = print,
                 track_train_rmse: bool = False):
        self.model = model
        self.solver = solver
        self.ev = evaluator
        self.params = params
        self.prefix = prefix
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.log_fn = log_fn
        self.track_train_rmse = track_train_rmse
        # IFWMF weights its objective (modelInvPopMF.cpp:22-32)
        w = model.example_weight(evaluator.train_coo.rows,
                                 evaluator.train_coo.cols)
        self.obj_weights = None if bool(jnp.all(w == 1.0)) else w

    def _objective(self, state: MFState) -> float:
        view = self.model.eval_view(state)
        return self.ev.objective(view, state, self.obj_weights,
                                 use_factors=self.model.use_factors,
                                 use_bias=self.model.use_bias)

    def run(self, state: MFState, seed: Optional[int] = None,
            resume: bool = False) -> TrainReport:
        """``resume=True`` with a prefix continues from the last full
        loop checkpoint ({prefix}_loop.npz): epoch counter, lr, best
        state and the termination counters are all restored (the
        multi-host-restart semantics SURVEY §5 calls for)."""
        p = self.params
        lr = p.learn_rate
        key = jax.random.PRNGKey(p.seed if seed is None else seed)

        # solvers donate their input state buffers; snapshots must be
        # real copies or they alias deleted arrays after the next epoch
        snapshot = lambda st: jax.tree_util.tree_map(jnp.copy, st)
        best_iter = -1
        start_iter = 0
        history: List[EpochLog] = []
        stop = "max_iter"
        sig = (ckpt.model_signature(p, self.model.n_users,
                                    self.model.n_items)
               if self.prefix else None)
        loop_path = f"{self.prefix}_loop.npz" if self.prefix else None
        best_path = (loop_path.replace("_loop.npz", "_loop_best.npz")
                     if loop_path else None)

        # a run killed between the loop.npz and best.npz writes must
        # restart gracefully, not crash resume (review r3)
        resuming = bool(resume and loop_path
                        and os.path.exists(loop_path)
                        and os.path.exists(best_path))
        if resume and loop_path and os.path.exists(loop_path) \
                and not resuming:
            self.log_fn(f"resume requested but {best_path} is missing "
                        "(interrupted mid-save?) — starting fresh")
        if resuming:
            state, extra = ckpt.load_state(loop_path)
            best_state, _ = ckpt.load_state(best_path)
            lr = float(extra["lr"])
            best_val = float(extra["best_val"])
            best_iter = int(extra["best_iter"])
            prev_obj = float(extra["prev_obj"])
            start_iter = int(extra["epoch"]) + 1
            if "key_data" in extra:
                # exact resume: the raw PRNG key is persisted, so the
                # epoch-key chain continues bit-identically
                key = jnp.asarray(extra["key_data"], dtype=jnp.uint32)
            else:   # older checkpoints (pre round 2)
                key = jax.random.PRNGKey(int(extra["key_seed"]))
            if hasattr(self.solver, "set_internal_state"):
                self.solver.set_internal_state(
                    {k[len("solver__"):]: v for k, v in extra.items()
                     if k.startswith("solver__")})
            self.log_fn(f"resumed from {loop_path} at epoch {start_iter}")
        else:
            best_state = snapshot(state)
            prev_obj = self._objective(state)
            best_val = self.ev.rmse(self.model.eval_view(state), "val")

        for it in range(start_iter, p.max_iter):
            key, ek = jax.random.split(key)
            t0 = time.time()
            state = self.solver.epoch(state, lr, ek)
            jax.block_until_ready(state)  # honest epoch timing
            dt = time.time() - t0

            if it % p.obj_iter == 0 or it == p.max_iter - 1:
                view = self.model.eval_view(state)
                obj = self._objective(state)
                val = self.ev.rmse(view, "val")

                # NaN rollback (model.cpp:1487-1498)
                if not (np.isfinite(obj) and np.isfinite(val)):
                    if lr > 1e-5:
                        self.log_fn(f"epoch {it}: non-finite obj/val — "
                                    f"rollback to best, lr {lr} -> {lr/2}")
                        state = snapshot(best_state)
                        if hasattr(self.solver, "reset"):
                            self.solver.reset()
                        lr /= 2
                        continue
                    stop = "nan_at_min_lr"
                    break

                if val < best_val:
                    best_state = snapshot(state)
                    best_val = val
                    best_iter = it

                if it - best_iter >= 100 and lr > 1e-5:
                    lr /= 2

                if it - best_iter >= p.chance_iter:
                    stop = "not_converged_chance_iter"
                    break

                converged = abs(prev_obj - obj) < p.eps
                prev_obj = obj

                tr_rmse = (self.ev.rmse(view, "train")
                           if self.track_train_rmse else float("nan"))
                history.append(EpochLog(it, obj, val, tr_rmse, lr, dt))
                if it % p.disp_iter == 0:
                    self.log_fn(
                        f"epoch {it}: obj {obj:.6e} val_rmse {val:.6f} "
                        f"lr {lr:g} {dt*1000:.1f}ms")

                if self.prefix and (it % p.save_iter == 0
                                    or it == p.max_iter - 1):
                    self._save_text(best_state, sig)
                    solver_extra = {}
                    if hasattr(self.solver, "internal_state"):
                        solver_extra = {
                            "solver__" + k: np.asarray(v) for k, v in
                            self.solver.internal_state().items()}
                    ckpt.save_state(loop_path, state,
                                    epoch=np.int64(it),
                                    lr=np.float64(lr),
                                    best_val=np.float64(best_val),
                                    best_iter=np.int64(best_iter),
                                    prev_obj=np.float64(prev_obj),
                                    key_data=np.asarray(key),
                                    **solver_extra)
                    ckpt.save_state(loop_path.replace("_loop.npz", "_loop_best.npz"), best_state)

                if converged:
                    stop = "converged"
                    break

        if self.prefix:
            self._save_text(best_state, sig)
            if self.invalid_users is not None:
                ckpt.save_invalid(self.prefix, self.invalid_users,
                                  self.invalid_items)
        return TrainReport(state, best_state, best_val, best_iter, stop,
                           history)

    def _save_text(self, best_state: MFState, sig: str) -> None:
        """Text checkpoint of the best snapshot: bias models persist
        mu/uBias/iBias alongside factors (Model::save model.cpp:31-58);
        factor-only models write just the factor .mats (saveFacs)."""
        if getattr(self.model, "use_bias", False):
            ckpt.save_full(best_state, self.prefix, sig)
        else:
            ckpt.save_facs(best_state, self.prefix, sig)


class TrainLoopHR:
    """Ranking-model training loop — model selection on validation HR@10.

    Semantics of Model::isTerminateModelHR (model.cpp:1335-1377) wrapped
    around ModelMFBPR::train's epoch structure (modelMFBPR.cpp:469-554):
    lr decays x0.9 every epoch, best snapshot on HR improvement, halving
    at 100 stagnant epochs, CHANCE_ITER give-up, non-finite-loss abort.
    """

    def __init__(self, model, solver, scorer, val_mat, params: Params,
                 log_fn: Callable[[str], None] = print,
                 metric_fn: Optional[Callable] = None,
                 prefix: Optional[str] = None,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None):
        """``metric_fn(view) -> float`` (higher = better) overrides the
        default val HR@10 — e.g. NDCG for the trainHogPosNeg protocol
        (modelMFBPR.cpp:633, isTerminateModelNDCG model.cpp:1379).
        ``prefix`` enables the same checkpoint protocol as TrainLoop:
        the reference persists the best-on-validation BPR model exactly
        like the MF models (bestModel, model.cpp:89-101 via
        modelMFBPR.cpp:405-559)."""
        self.model = model
        self.solver = solver
        self.scorer = scorer
        self.val_mat = val_mat
        self.params = params
        self.log_fn = log_fn
        self.prefix = prefix
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.metric_fn = metric_fn or (
            lambda view: self.scorer.hit_rate(view, self.val_mat, 10))

    def run(self, state: MFState, seed: Optional[int] = None,
            resume: bool = False) -> TrainReport:
        """``resume=True`` with a prefix continues bit-exactly from the
        last {prefix}_loop.npz: epoch counter, decayed lr, best
        HR/snapshot, the raw PRNG key chain and the solver's last
        loss/inversions are all restored."""
        p = self.params
        lr = p.learn_rate
        key = jax.random.PRNGKey(p.seed if seed is None else seed)
        snapshot = lambda st: jax.tree_util.tree_map(jnp.copy, st)

        best_iter = -1
        start_iter = 0
        history: List[EpochLog] = []
        stop = "max_iter"
        sig = (ckpt.model_signature(p, self.model.n_users,
                                    self.model.n_items)
               if self.prefix else None)
        loop_path = f"{self.prefix}_loop.npz" if self.prefix else None
        best_path = (loop_path.replace("_loop.npz", "_loop_best.npz")
                     if loop_path else None)

        resuming = bool(resume and loop_path
                        and os.path.exists(loop_path)
                        and os.path.exists(best_path))
        if resume and loop_path and os.path.exists(loop_path) \
                and not resuming:
            self.log_fn(f"resume requested but {best_path} is missing "
                        "(interrupted mid-save?) — starting fresh")
        if resuming:
            state, extra = ckpt.load_state(loop_path)
            best_state, _ = ckpt.load_state(best_path)
            lr = float(extra["lr"])
            best_hr = float(extra["best_hr"])
            best_iter = int(extra["best_iter"])
            start_iter = int(extra["epoch"]) + 1
            key = jnp.asarray(extra["key_data"], dtype=jnp.uint32)
            self.solver.last_loss = jnp.asarray(float(extra["last_loss"]))
            self.solver.last_inversions = jnp.asarray(
                int(extra["last_inversions"]), jnp.int32)
            self.log_fn(f"resumed from {loop_path} at epoch {start_iter}")
        else:
            # the initial full-catalog eval is expensive (PERF.md) —
            # skip it when the checkpoint will overwrite it anyway
            best_state = snapshot(state)
            best_hr = self.metric_fn(self.model.eval_view(state))

        for it in range(start_iter, p.max_iter):
            key, ek = jax.random.split(key)
            t0 = time.time()
            state = self.solver.epoch(state, lr, ek)
            jax.block_until_ready(state)
            dt = time.time() - t0
            loss = float(self.solver.last_loss)
            if not np.isfinite(loss):
                # reference exits hard (modelMFBPR.cpp:527-530)
                self.log_fn(f"epoch {it}: non-finite BPR loss {loss} — "
                            "stopping (decrease learn rate)")
                stop = "nonfinite_loss"
                break
            lr *= 0.9  # modelMFBPR.cpp:533

            if it % p.obj_iter == 0 or it == p.max_iter - 1:
                hr = self.metric_fn(self.model.eval_view(state))
                if hr > best_hr:
                    best_state = snapshot(state)
                    best_hr = hr
                    best_iter = it
                if it - best_iter >= 100 and lr > 1e-5:
                    lr /= 2
                if it - best_iter >= p.chance_iter:
                    stop = "not_converged_chance_iter"
                    break
                history.append(EpochLog(it, loss, hr, float("nan"), lr, dt))
                if it % p.disp_iter == 0:
                    self.log_fn(
                        f"epoch {it}: HR {hr:.4f} best {best_hr:.4f} "
                        f"loss {loss:.4e} inversions "
                        f"{int(self.solver.last_inversions)} "
                        f"lr {lr:g} {dt*1000:.1f}ms")

                if self.prefix and (it % p.save_iter == 0
                                    or it == p.max_iter - 1):
                    ckpt.save_facs(best_state, self.prefix, sig)
                    ckpt.save_state(
                        loop_path, state,
                        epoch=np.int64(it),
                        lr=np.float64(lr),
                        best_hr=np.float64(best_hr),
                        best_iter=np.int64(best_iter),
                        key_data=np.asarray(key),
                        last_loss=np.float64(loss),
                        last_inversions=np.int64(
                            self.solver.last_inversions))
                    ckpt.save_state(loop_path.replace(
                        "_loop.npz", "_loop_best.npz"), best_state)

        if self.prefix:
            ckpt.save_facs(best_state, self.prefix, sig)
            if self.invalid_users is not None:
                ckpt.save_invalid(self.prefix, self.invalid_users,
                                  self.invalid_items)
        return TrainReport(state, best_state, best_hr, best_iter, stop,
                           history)


# ----------------------------------------------------------------------
# one-call front door
# ----------------------------------------------------------------------

_SOLVERS = ("auto", "sgd", "sgdpar", "sgdparsvd", "sgdu", "hogsgd",
            "blocksgd", "densesgd", "als", "ialspp", "alsdense", "ccd",
            "ccd++", "ccd++freqadap")


def _auto_method(algo: str, data, params, mesh) -> str:
    """Solver choice by input properties (no reference analog — the
    reference makes the user pick):

    * plain MF on one device -> 'als': the coordinate family reaches
      the quality basin in ~10 epochs vs SGD's hundreds, so it wins on
      wall-clock-to-quality even where an SGD epoch is cheaper.
    * long-tail models (IFWMF/TMF/TMFDropout) train by SGD in the
      reference; pick the row-dense engine when its padded grid fits
      the byte budget below, else the one-hot block engine when the
      staged cell stream fits (~1.5x-padded 7-array stream), else the
      scatter engine.
    * under a multi-device mesh the same quality-basin argument holds:
      plain MF -> sharded bucketed ALS (SPMD auto-partitioning over the
      row-sharded tables, tests/test_parallel.py); SGD-trained
      long-tail families -> block-DSGD (the one-hot engine under the
      DSGD rotation; the dispatch falls back to the scatter DSGD for
      Poisson-sampled ranks, which the block engines cannot stage).
    """
    if mesh is not None:
        if algo == "mf":
            return "als"
        return "blocksgd"
    if algo == "mf":
        return "als"
    if algo in ("mf_bias", "tmf_bias", "mf_loc", "mf_freq",
                "dropoutmf", "dropoutmf_prob", "dropoutmf_ordered",
                "dropoutmf_onlyordered"):
        # biases and per-side update gates only train through the SGD
        # engine; adaptive-dropout models sample rank from update-mask
        # distributions no block engine stages
        return "sgd"
    # deterministic SGD-family models (TMF/IFWMF/weighted): prefer the
    # row-dense engine when the padded dense grid fits its byte
    # budget; else the one-hot stream when THAT fits; else scatter
    # SGD. The 2560/128 padding quantum and the 6e9/8e9 byte cuts are
    # inherited sizes, not yet re-derived from GPU cells (ROADMAP).
    nu_pad = -(-data.n_users // 2560) * 2560
    ni_pad = -(-data.n_items // 128) * 128
    # bytes/slot: 1 when the solver will stage int8 rating codes
    # (star-grid data + uniform-0/1 weights — every algo here except
    # IFWMF's popularity weights), else bf16 R + int8/bf16 W = 3
    bytes_per_slot = 3
    if algo != "ifwmf":
        from matfac_tpu.solvers.block_sgd import rating_code_scale
        v = data.train_mat.values
        if len(v) > 2_000_000:
            # O(nnz log nnz) unique is not worth exactness here: a
            # subsample decides the ROUTING estimate only — the solver
            # re-proves representability on the filtered data and the
            # densesgd dispatch falls back on its budget ValueError
            v = v[:: len(v) // 2_000_000]
        if rating_code_scale(v) is not None:
            bytes_per_slot = 1
    if nu_pad * ni_pad * bytes_per_slot <= 6e9:
        # incl. tmfdropout: the dense row engine resamples Poisson
        # ranks per stripe visit with the reference's exact per-update
        # marginal (README deviation #15)
        return "densesgd"
    if algo == "tmfdropout":
        # over-budget grids: sampled ranks need the scatter engine's
        # per-update masks (the one-hot stream stages static ranks)
        return "sgd"
    est_stream_bytes = 7 * 4 * 1.5 * max(data.train_mat.nnz, 1)
    if est_stream_bytes < 8e9:
        return "blocksgd"
    return "sgd"


def train_model(data, params: Params, algo: str = "mf",
                mf_method: str = "sgd", log_fn=print,
                init_state_override: Optional[MFState] = None,
                prefix: Optional[str] = None, mesh=None,
                resume: bool = False):
    """Build model+solver from reference-parity names and train.

    algo: mf | mf_bias | IFWMF | TMF | TMFDropout  (main.cpp --algo)
    mf_method: sgd | sgdpar | sgdu | hogsgd | als | ccd | ccd++
      (main.cpp --mf_method; all four SGD spellings map to the one
      minibatched engine)
    resume: continue from {prefix}_loop.npz if present (bit-exact for
      both the pointwise and the ranking loops).
    Returns (report, model, evaluator, invalid masks).
    """
    from matfac_tpu.models.base import ModelMF, ModelMFBias, init_state
    from matfac_tpu.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
    from matfac_tpu.models.longtail import (ModelDropoutSigmoid,
                                            ModelInvPopMF,
                                            ModelPoissonDropout)
    from matfac_tpu.solvers.als import ALSSolver
    from matfac_tpu.solvers.bpr import BPRSolver
    from matfac_tpu.solvers.ccd import CCDPPSolver, CCDSolver
    from matfac_tpu.solvers.sgd import SGDSolver
    from matfac_tpu.utils import freq as ufreq

    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    user_freq, item_freq = ufreq.row_col_freq(data.train_mat)
    # zero-pad (NOT np.resize, which tiles cyclically): entities that
    # appear only in test/val have zero train frequency in the reference
    user_freq = _pad_rows(user_freq, data.n_users)
    item_freq = _pad_rows(item_freq, data.n_items)
    import jax as _jax
    if _jax.process_count() > 1:
        # each process may hold only its host-local rating rows
        # (parallel.distributed.host_local_ratings): model statistics
        # (freq tables -> IFWMF weights, TMF rank tables, head masks)
        # and invalid masks must be GLOBAL or the staged per-pair
        # weights/ranks differ across processes (review r3). Summed
        # counts also fix invalid masks: an item rated only on another
        # host is globally valid. (Processes holding the FULL matrix
        # just scale counts xP — every derived statistic is
        # scale-invariant: argsort order, normalized popularity,
        # z-scores, mass quantiles.)
        from jax.experimental import multihost_utils
        user_freq = multihost_utils.process_allgather(
            np.asarray(user_freq, np.int64)).sum(axis=0)
        item_freq = multihost_utils.process_allgather(
            np.asarray(item_freq, np.int64)).sum(axis=0)
        inval_u = user_freq == 0
        inval_i = item_freq == 0

    a = algo.lower()
    if a in ("bpr", "bprpoissondropout", "bpr_poisson"):
        if mf_method.lower() == "auto":
            # ranking trains through the one pairwise engine; 'train'
            # (stream mode + HR selection) is the reference default
            mf_method = "train"
            log_fn("mf_method=auto resolved to 'train' (BPR stream)")
        return _train_ranking(data, params, a, mf_method, log_fn,
                              init_state_override, inval_u, inval_i,
                              user_freq, item_freq, prefix, resume)

    if a == "increment":
        # ModelIncrement dispatch (main.cpp:1325-1370 reaches it from
        # --algo; probe matrix = --graphmat, modelIncrement.cpp:251-316)
        from matfac_tpu.models.increment import train_increment
        inc_report, model = train_increment(data, params, inval_u,
                                            inval_i, log_fn=log_fn)
        ev = Evaluator(data, inval_u, inval_i, params)
        val = ev.rmse(model.eval_view(inc_report.state), "val")
        report = TrainReport(inc_report.state, inc_report.state, val,
                             params.max_iter - 1, "max_iter", [])
        report.increment = inc_report    # rank tables + growth history
        return report, model, ev, (inval_u, inval_i)

    if a in ("mf_freq", "mffreq"):
        # othersrc ModelMFFreq: 5-phase head-first curriculum
        # (othersrc/modelMFFreq.cpp:200-278)
        return _train_mf_freq(data, params, mf_method, log_fn,
                              init_state_override, inval_u, inval_i,
                              user_freq, item_freq, prefix, resume,
                              mesh)

    if a in ("mf_headwt", "mfwt"):
        # othersrc ModelMFWt: head-item down-weighting (head_pc and
        # lambda0 pinned to the reference's constants,
        # othersrc/modelMFWt.cpp:118-120)
        from matfac_tpu.models.longtail import ModelHeadWeightedMF
        a = "mf_headwt"
        model = ModelHeadWeightedMF(
            params, data.n_users, data.n_items,
            ufreq.head_items_from_freq(item_freq, 0.5), lambda0=0.8)
    elif a in ("dropoutmf", "dropoutmf_prob", "dropoutmf_ordered",
               "dropoutmf_onlyordered"):
        # othersrc ModelDropoutMF: quartile rank maps + soft three-tier
        # scoring; algo suffix picks the trainer's rank-sampling rule
        from matfac_tpu.models.longtail import ModelAdaptiveDropoutMF
        mode = {"dropoutmf": "prob", "dropoutmf_prob": "prob",
                "dropoutmf_ordered": "ordered",
                "dropoutmf_onlyordered": "onlyordered"}[a]
        a = "dropoutmf"
        model = ModelAdaptiveDropoutMF(params, data.n_users,
                                       data.n_items, user_freq,
                                       item_freq, mode=mode)
    elif a in ("mf_loc", "mfloc"):
        # othersrc ModelMFLoc: tail entities confined to the first
        # fac_dim/2 dims (othersrc/modelMFLoc.cpp; head sets at the
        # same 0.8 rating-mass cut ModelMFFreq uses,
        # othersrc/modelMFFreq.cpp:211-212)
        from matfac_tpu.models.longtail import ModelLocalityMF
        a = "mf_loc"
        model = ModelLocalityMF(
            params, data.n_users, data.n_items,
            ufreq.head_items_from_freq(user_freq, 0.8),
            ufreq.head_items_from_freq(item_freq, 0.8))
    else:
        from matfac_tpu.models.longtail import ModelDropoutSigmoidBias
        models = {"mf": ModelMF, "mf_bias": ModelMFBias,
                  "ifwmf": ModelInvPopMF, "tmf": ModelDropoutSigmoid,
                  "tmfdropout": ModelPoissonDropout,
                  "tmf_bias": ModelDropoutSigmoidBias}
        cls = models[a]
        model = cls(params, data.n_users, data.n_items,
                    user_freq=user_freq, item_freq=item_freq,
                    invalid_users=inval_u, invalid_items=inval_i) \
            if cls is ModelInvPopMF else \
            cls(params, data.n_users, data.n_items,
                user_freq=user_freq, item_freq=item_freq) \
            if cls in (ModelDropoutSigmoid, ModelPoissonDropout,
                       ModelDropoutSigmoidBias) else \
            cls(params, data.n_users, data.n_items)

    m = mf_method.lower()
    if m == "auto":
        m = _auto_method(a, data, params, mesh)
        log_fn(f"mf_method=auto resolved to '{m}'")
        if m == "densesgd":
            # the dense row engine's effective minibatch is a full user
            # stripe (README deviation #1) — surface the dynamics
            # change the auto default implies at a fixed learn_rate
            log_fn("note: densesgd trains at batch = user stripe; at a "
                   "fixed learn_rate this differs from the blocksgd "
                   "default's ~1-8k minibatches (pass mf_method="
                   "'blocksgd' to keep the previous default)")
    if mesh is not None and model.use_bias:
        # DSGD/BlockDSGD update factors only; routing a bias model
        # there would silently freeze mu/uBias/iBias
        raise ValueError(
            "mesh training does not support bias models (the DSGD "
            "engines update factors only) — train mf_bias on a single "
            "device, as the reference does (modelMFBias.cpp:103-227)")
    if (mesh is not None and getattr(model, "stochastic_rank", False)
            and not hasattr(model, "pair_lambda")):
        # the DSGD engines sample only Poisson ranks in-kernel; an
        # adaptive-dropout model would silently train deterministic
        # truncation (othersrc has no distributed trainer either)
        raise ValueError(
            f"mesh training does not support {model.name}'s sampled "
            "ranks — train it single-device with mf_method=sgd")
    side_gated = (type(model).update_side_masks
                  is not ModelMF.update_side_masks)
    if side_gated and (mesh is not None
                       or m not in ("sgd", "sgdpar", "sgdu", "hogsgd")):
        # per-side update gates (mf_loc/mf_freq) are consumed by the
        # scatter SGD engine only; the block/DSGD engines and the
        # coordinate family would silently train both sides at full
        # rank. The reference trains these models sequentially too
        # (othersrc/modelMFLoc.cpp:34, modelMFFreq.cpp:141).
        raise ValueError(
            f"{model.name} carries per-side update gates that "
            f"'{m}'{' under a mesh' if mesh is not None else ''} does "
            "not honor — use mf_method=sgd on a single device")
    if m in ("als", "ialspp", "alsdense", "ccd", "ccd++", "ccdpp",
             "ccd++freqadap"):
        # the coordinate solvers ignore example_weight / rank-mask
        # hooks; routing a weighted or rank-masked model there would
        # silently train plain MF while TrainLoop logs a WEIGHTED
        # objective (review r3). The reference trains these families
        # through SGD/DSGD too (modelInvPopMF.cpp:229,
        # modelDropoutSigmoid.cpp:26, modelMFWt.cpp:151).
        weighted = (type(model).example_weight
                    is not ModelMF.example_weight)
        masked = (hasattr(model, "pair_rank")
                  or hasattr(model, "pair_lambda")
                  or type(model).update_side_masks
                  is not ModelMF.update_side_masks)
        if weighted or masked:
            raise ValueError(
                f"{model.name} carries per-example weights/rank masks "
                f"that '{m}' (coordinate family) does not honor — use "
                "an SGD-family method (sgd/blocksgd/sgdpar/auto)")
    if params.reg_exponent and m not in ("als", "sgd", "sgdpar",
                                         "sgdu", "hogsgd"):
        # the per-entity lambda is implemented in the bucketed ALS and
        # the scatter SGD engine; everything else would silently train
        # flat lambda (review r3)
        raise ValueError(
            f"reg_exponent is implemented for 'als' and the sgd "
            f"engine, not '{m}' — drop the exponent or switch method")
    sing_vals = None
    t_stage = time.perf_counter()
    if mesh is not None and m == "densesgd":
        # multi-device row-dense engine: DSGD rotation outside, dense
        # stripe sweeps inside each shard-round (the round-4 headline
        # engine's multi-chip vehicle). Rank-masked/sampled models,
        # multi-process runs, and over-budget dense grids fall back to
        # the one-hot / scatter mesh paths.
        try:
            from matfac_tpu.parallel.block_dsgd import (
                DenseBlockDSGDSolver)
            solver = DenseBlockDSGDSolver(
                model, params, data.train_mat, inval_u, inval_i, mesh)
        except ValueError as e:
            log_fn(f"mesh densesgd unavailable ({e}); falling back "
                   "to mesh blocksgd")
            m = "blocksgd"
    if mesh is not None and m == "blocksgd":
        # multi-device one-hot engine: DSGD rotation outside,
        # block-SGD sweeps inside each shard-round; multi-process runs
        # stage per process (parallel/block_dsgd.py). Models the block
        # engine cannot stage (Poisson-sampled ranks) fall back to the
        # scatter DSGD, which samples in-kernel.
        if hasattr(model, "pair_lambda"):
            from matfac_tpu.parallel.dsgd import DSGDShardedSolver
            solver = DSGDShardedSolver(model, params, data.train_mat,
                                       inval_u, inval_i, mesh)
            m = "sgd"
            log_fn("mesh blocksgd: fell back to the scatter DSGD "
                   "(Poisson-sampled ranks)")
        else:
            from matfac_tpu.parallel.block_dsgd import BlockDSGDSolver
            solver = BlockDSGDSolver(
                model, params, data.train_mat, inval_u, inval_i, mesh,
                batch_size=None,   # auto-sized per-step work
                pad_k=128 if params.fac_dim <= 128 else 0)
    elif mesh is not None and m in ("sgd", "sgdpar", "sgdu", "hogsgd"):
        # multi-device: block-stratified DSGD over the mesh
        from matfac_tpu.parallel.dsgd import DSGDShardedSolver
        solver = DSGDShardedSolver(model, params, data.train_mat,
                                   inval_u, inval_i, mesh)
    elif m in ("sgd", "sgdpar", "sgdu", "hogsgd"):
        rs_u = rs_i = None
        if params.reg_exponent:
            # per-occurrence multiplier normalized by the mean valid
            # frequency so reg magnitude stays comparable at exponent 0
            e = params.reg_exponent
            rs_u = _freq_reg_scale(user_freq, inval_u, e)
            rs_i = _freq_reg_scale(item_freq, inval_i, e)
        solver = SGDSolver(model, params, data.train_mat, inval_u,
                           inval_i, reg_scale_u=rs_u, reg_scale_i=rs_i)
    elif m == "blocksgd":
        # one-hot cell engine (ops/block_sgd_kernel.py) — same update
        # semantics as sgd with gathers/scatters as one-hot matmuls:
        # DSGD-round diag schedule, 384-blocks, k zero-padded to 128
        # (exact equivalence; solvers/block_sgd.py pad_k).
        from matfac_tpu.solvers.block_sgd import BlockSGDSolver
        solver = BlockSGDSolver(model, params, data.train_mat, inval_u,
                                inval_i,
                                batch_size=min(params.batch_size, 1024),
                                bu=384, bi=384, schedule="diag",
                                pad_k=128 if params.fac_dim <= 128
                                else 0)
    elif m == "densesgd":
        # dense-cell masked-residual engine (ops/dense_block_kernel.py):
        # the blocksgd update at batch = cell, as 3 dense matmuls per
        # cell with no one-hots — gated on the dense-tile byte budget
        # (the solver raises when the padded matrix exceeds it)
        if mesh is not None:
            pass   # DenseBlockDSGDSolver constructed above
        else:
            from matfac_tpu.solvers.block_sgd import BlockSGDSolver
            try:
                solver = BlockSGDSolver(model, params, data.train_mat,
                                        inval_u, inval_i,
                                        engine="dense",
                                        bu=None, bi=None)
            except ValueError as e:
                # over-budget grids (e.g. the auto-routing estimate
                # used 1 B/slot codes but the filtered data staged
                # float tiles) fall back rather than crash; sampled-
                # rank models need the scatter engine's masks
                fb = ("sgd" if getattr(model, "stochastic_rank", False)
                      else "blocksgd")
                log_fn(f"densesgd unavailable ({e}); falling back "
                       f"to {fb}")
                m = fb
                if fb == "sgd":
                    solver = SGDSolver(model, params, data.train_mat,
                                       inval_u, inval_i)
                else:
                    solver = BlockSGDSolver(
                        model, params, data.train_mat, inval_u,
                        inval_i,
                        batch_size=min(params.batch_size, 1024),
                        bu=384, bi=384, schedule="diag",
                        pad_k=128 if params.fac_dim <= 128 else 0)
    elif m == "sgdparsvd":
        # trainSGDParSVD (modelMF.cpp:353-557): SVD init + per-dim
        # singular-value-weighted regularization + objectiveSing
        import jax.numpy as jnp
        from matfac_tpu.ops.svd_init import svd_init
        u0, v0, sing_vals = svd_init(data.train_mat, params.fac_dim)
        sa = params.u_reg if params.sing_a is None else params.sing_a
        sb = params.i_reg if params.sing_b is None else params.sing_b
        reg = (sa + 1.0) / (sb + sing_vals)
        solver = SGDSolver(model, params, data.train_mat, inval_u,
                           inval_i, reg_vec=reg)
        if init_state_override is None:
            st = init_state(params, data.n_users, data.n_items)
            u0 = _pad_rows(u0, data.n_users)
            v0 = _pad_rows(v0, data.n_items)
            init_state_override = st._replace(u_fac=jnp.asarray(u0),
                                              i_fac=jnp.asarray(v0))
    elif m == "als":
        solver = ALSSolver(model, params, data.train_mat, inval_u, inval_i)
    elif m == "ialspp":
        from matfac_tpu.solvers.als import SubspaceALSSolver
        solver = SubspaceALSSolver(model, params, data.train_mat,
                                   inval_u, inval_i)
    elif m == "alsdense":
        from matfac_tpu.solvers.als import DenseALSSolver
        solver = DenseALSSolver(model, params, data.train_mat,
                                inval_u, inval_i)
    elif m == "ccd":
        if not data.train_mat.is_sorted():
            raise ValueError("CCD requires sorted CSR (main.cpp:1245)")
        solver = CCDSolver(model, params, data.train_mat, inval_u, inval_i)
    elif m in ("ccd++", "ccdpp"):
        solver = CCDPPSolver(model, params, data.train_mat, inval_u,
                             inval_i,
                             group_dims=getattr(params,
                                                "ccd_group_dims", 1))
    elif m == "ccd++freqadap":
        solver = CCDPPSolver(model, params, data.train_mat, inval_u,
                             inval_i, freq_adaptive=True,
                             item_freq=item_freq,
                             group_dims=getattr(params,
                                                "ccd_group_dims", 1))
    else:
        raise ValueError(f"unknown mf_method {mf_method!r}; "
                         f"one of {_SOLVERS}")

    # under a mesh the per-epoch metric reductions shard across it
    # (mesh-sharded eval — SURVEY §7 "Eval cost")
    ev = Evaluator(data, inval_u, inval_i, params, mesh=mesh)
    state = init_state_override or init_state(params, data.n_users,
                                              data.n_items)
    # model-specific init transform (identity for most; mf_loc zeroes
    # tail entities' upper dims — applied to loaded inits too, like
    # zeroedTail*Facs runs inside train, othersrc/modelMFLoc.cpp:52-53)
    state = model.transform_init_state(state)
    if mesh is not None and m in ("als", "ialspp", "alsdense"):
        # row-shard the tables so SPMD auto-partitioning spreads the
        # bucketed Gram + batched solve over the mesh
        from matfac_tpu.parallel.mesh import shard_state
        ax = mesh.axis_names[0]
        state = shard_state(state, mesh, u_axis=ax, i_axis=ax)
    staging_s = time.perf_counter() - t_stage
    loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                     invalid_users=inval_u, invalid_items=inval_i,
                     log_fn=log_fn)
    if sing_vals is not None:
        # isTerminateModelSing path: objective uses sigma-weighted L2
        loop._objective = lambda st: ev.objective_sing(
            model.eval_view(st), st, sing_vals)
    report = loop.run(state, resume=resume)
    report.method, report.staging_seconds = m, staging_s
    return report, model, ev, (inval_u, inval_i)


def _train_mf_freq(data, params: Params, mf_method: str, log_fn,
                   init_state_override, inval_u, inval_i,
                   user_freq, item_freq, prefix, resume, mesh):
    """ModelMFFreq's head-first curriculum
    (othersrc/modelMFFreq.cpp:200-278): five successive subTrain
    stages over the SAME factor state, each a full max_iter loop with
    the learn rate reset (learnRate = origLearnRate before every
    stage), gating which SIDE of each example updates:

      1. all valid entities            (plain warm-up)
      2. head users x head items       (80% rating-mass heads)
      3. items only, tail items        (users frozen)
      4. users only, tail users        (items frozen)
      5. all valid entities            (final polish)

    Each stage continues from the CURRENT state (the reference's
    subTrain mutates this->uFac; bestModel is only for
    saving/termination); the returned best snapshot is the best
    val-RMSE state seen across ALL stages (the reference threads one
    bestModel through every call).
    """
    from matfac_tpu.models.base import init_state
    from matfac_tpu.models.longtail import ModelSideGatedMF
    from matfac_tpu.solvers.sgd import SGDSolver
    from matfac_tpu.utils import freq as ufreq

    if mesh is not None:
        raise ValueError("mf_freq trains on a single device "
                         "(sequential curriculum, modelMFFreq.cpp:141)")
    if resume:
        raise ValueError("resume is not supported for the mf_freq "
                         "curriculum — restart the stage sequence")
    m = mf_method.lower()
    if m == "auto":
        m = "sgd"
        log_fn("mf_method=auto resolved to 'sgd' (curriculum stages)")
    if m not in ("sgd", "sgdpar", "sgdu", "hogsgd"):
        raise ValueError(
            f"mf_freq trains through the SGD engine, not '{m}'")

    head_u = ufreq.head_items_from_freq(user_freq, 0.8)
    head_i = ufreq.head_items_from_freq(item_freq, 0.8)
    valid_u, valid_i = ~inval_u, ~inval_i
    none_u = np.zeros(data.n_users, bool)
    none_i = np.zeros(data.n_items, bool)
    stages = [
        ("full", valid_u, valid_i),
        ("head-only", head_u & valid_u, head_i & valid_i),
        ("tail-items", none_u, ~head_i & valid_i),
        ("tail-users", ~head_u & valid_u, none_i),
        ("full", valid_u, valid_i),
    ]

    ev = Evaluator(data, inval_u, inval_i, params)
    state = init_state_override or init_state(params, data.n_users,
                                              data.n_items)
    snapshot = lambda st: jax.tree_util.tree_map(jnp.copy, st)
    best_state, best_metric, best_iter = None, float("inf"), -1
    history: List[EpochLog] = []
    epoch_off = 0
    model = None
    stop = "max_iter"
    for si, (tag, gu, gi) in enumerate(stages):
        log_fn(f"mf_freq stage {si + 1}/5 ({tag}): "
               f"{int(gu.sum())} users x {int(gi.sum())} items trainable")
        model = ModelSideGatedMF(params, data.n_users, data.n_items,
                                 gu, gi)
        solver = SGDSolver(model, params, data.train_mat, inval_u,
                           inval_i)
        loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                         invalid_users=inval_u, invalid_items=inval_i,
                         log_fn=log_fn)
        rep = loop.run(state, seed=params.seed + si)
        state = rep.state
        for el in rep.history:
            el.epoch += epoch_off
            history.append(el)
        if rep.best_metric < best_metric:
            best_metric = rep.best_metric
            best_state = snapshot(rep.best_state)
            best_iter = rep.best_iter + epoch_off
        epoch_off += params.max_iter
        stop = rep.stop_reason
    report = TrainReport(state, best_state, best_metric, best_iter,
                         stop, history)
    return report, model, ev, (inval_u, inval_i)


def _train_ranking(data, params, algo, mf_method, log_fn,
                   init_state_override, inval_u, inval_i,
                   user_freq, item_freq, prefix=None, resume=False):
    """BPR family (main dispatch has no BPR hook in the reference — it's
    reached by editing dispatch, SURVEY.md §3.4 — here it's first-class).
    mf_method: 'train' (sequential analog) and 'hog' both map to the
    minibatched pairwise engine; sigmoid variant = deterministic rank."""
    from matfac_tpu.eval.ranking import CatalogScorer
    from matfac_tpu.models.base import init_state
    from matfac_tpu.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
    from matfac_tpu.solvers.bpr import BPRSolver

    if algo == "bpr":
        model = ModelMFBPR(params, data.n_users, data.n_items)
    else:
        model = ModelBPRPoissonDropout(
            params, data.n_users, data.n_items, user_freq, item_freq,
            sample_poisson=(mf_method != "sigmoid"))
    mode = ("posneg" if mf_method.lower() in ("hogposneg", "posneg")
            else "stream")
    engine = getattr(params, "bpr_engine", "stream")
    t_stage = time.perf_counter()
    if engine == "dense" and mode == "stream":
        from matfac_tpu.solvers.bpr_dense import DenseBPRSolver
        try:
            solver = DenseBPRSolver(model, params, data.train_mat,
                                    inval_u, inval_i)
        except ValueError as e:   # rank-masked model / byte budget
            log_fn(f"bpr_engine=dense unavailable ({e}); "
                   "falling back to the stream engine")
            engine = "stream"
            solver = BPRSolver(model, params, data.train_mat, inval_u,
                               inval_i, n_tries=params.n_negatives,
                               mode=mode, sampler=params.bpr_sampler)
    else:
        engine = "stream"
        solver = BPRSolver(model, params, data.train_mat, inval_u,
                           inval_i, n_tries=params.n_negatives,
                           mode=mode, sampler=params.bpr_sampler)
    staging_s = time.perf_counter() - t_stage
    scorer = CatalogScorer(data.train_mat, inval_u, inval_i,
                           data.n_users, data.n_items,
                           user_block=min(params.eval_user_block,
                                          _round_up_pow2(data.n_users)),
                           item_block=params.eval_item_block)
    state = init_state_override or init_state(params, data.n_users,
                                              data.n_items)
    metric_fn = None
    if mf_method.lower() in ("hog", "hogposneg", "posneg"):
        # trainHog / trainHogPosNeg select on validation NDCG
        # (modelMFBPR.cpp:245-402 / :633)
        from matfac_tpu.eval.metrics import Evaluator
        ev = Evaluator(data, inval_u, inval_i, params)
        metric_fn = lambda view: ev.ndcg(view, "val")
    loop = TrainLoopHR(model, solver, scorer, data.val_mat, params,
                       log_fn=log_fn, metric_fn=metric_fn,
                       prefix=prefix, invalid_users=inval_u,
                       invalid_items=inval_i)
    report = loop.run(state, resume=resume)
    report.method, report.staging_seconds = f"bpr_{engine}", staging_s
    return report, model, scorer, (inval_u, inval_i)


def _freq_reg_scale(freq: np.ndarray, invalid: np.ndarray,
                    exponent: float) -> np.ndarray:
    """(freq / mean valid freq)^exponent — the SGD-side frequency-
    scaled reg multiplier (othersrc modelMFWtReg.cpp:96 semantics with
    a normalized marginal so exponent tuning does not shift the
    overall reg magnitude)."""
    f = np.asarray(freq, np.float64)
    valid = ~invalid[: len(f)]
    mean = max(float(f[valid].mean()) if valid.any() else 1.0, 1e-12)
    return np.maximum(f / mean, 1e-12) ** exponent


def _round_up_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Truncate or zero-pad the leading axis to length n (out-of-train
    entities get zeros, matching the reference's treatment)."""
    a = np.asarray(a)
    if a.shape[0] >= n:
        return a[:n]
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)
