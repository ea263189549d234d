"""Driver for a configuration that is a language model trained as
published: the program's training step, ``make_train_step``, on the
registry's model.

Set-up builds the model from the registry (``build_model``), with each
published value of the configuration file in its config and the traffic's
MoE dispatch, draws its fp32 master weights from the seed on the device,
and warms up.  A step draws its batch on the host from the program's
``SyntheticLM`` stream (``make_batch_iterator``, seeded by the seed, as
``launch/train.py`` draws them) and runs one training step: forward,
backward (remat), clipping and AdamW.  Steps run as one client with
``in_flight`` steps outstanding, each timed by CUDA events recorded before
its first operation and after its last.

The check keeps two steps of the window, one drawn from the seed among its
first ``check.sample_below`` and its last: the parameters and AdamW
moments before each and the parameters after it (copied to pinned host
memory on a side stream while the steps run, so the device's peak is
untouched), its batch and its loss.  After the program is freed,
:meth:`Run.check` recomputes each step's loss and gradients with
``loss_and_grads``, the function the step runs, recording the experts the
program routes each token to; requires the loss to equal the step's bit
for bit; and compares with the plain fp32 reference
(``bench/granite_moe_ref.py``) on the same parameters and batch, its
routes pinned to the program's:

- ``loss_rel_err`` = |loss - loss_ref| / |loss_ref|;
- ``grad_rel_err`` = the worst leaf's ||g - g_ref|| / ||g_ref||;
- ``route_gap``: how far the program's experts depart from the
  reference's top-k on the reference's own logits (the reference's
  ``Step.route_gap``): rounding moves only near ties, a fault in the
  router moves tokens far;
- ``update_rel_err`` = the worst leaf's ||dp - dp_ref|| / ||dp_ref||,
  where dp is the step's change of the parameters and dp_ref the
  reference's AdamW step (``adamw_step``, the configuration's
  ``optimizer``) from the same parameters and moments with the
  reference's gradients: a state left unchanged reads 1.

Pinning matters: unpinned, a token whose 8th and 9th logits nearly tie is
routed otherwise in bf16, and its gradient differs by far more than
rounding (``bench/train_readings.py --unpinned-seeds`` reads both).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from collections import deque

import numpy as np
import torch

from bench import granite_moe_ref as reference
from bench import tracing, train_trace, train_work
from bench.drivers.layer_products import _Stamp


def program_config(cfg, traffic):
    """The registry's config of ``cfg["arch"]`` with each published value
    of the configuration file set on it, and the traffic's MoE dispatch.
    For a file that states the registry's own values the config is the
    registry's, its dispatch aside."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Scales

    base = get_config(cfg["arch"])
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_head=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        dtype=cfg["dtype"],
        scales=Scales(embedding=cfg["embedding_multiplier"],
                      attention=cfg["attention_multiplier"],
                      residual=cfg["residual_multiplier"],
                      logits=cfg["logits_scaling"]),
        moe=dataclasses.replace(base.moe,
                                num_experts=cfg["num_local_experts"],
                                top_k=cfg["num_experts_per_tok"],
                                strategy=traffic["moe_strategy"]))


def _seed(seed):
    return int(seed) % 2 ** 63


class Run:
    """One cell's program state and what its window measured."""

    #: steps outstanding: the host enqueues a step, then waits on the
    #: oldest
    in_flight = 2
    #: what is kept of a step, each as long as the parameters
    KEPT = ("params", "m", "v", "after")

    def __init__(self, cfg, traffic, seed, device):
        from repro_torch.checkpoint.checkpointer import tree_flatten, tree_map
        from repro_torch.configs.base import TrainConfig
        from repro_torch.data.pipeline import make_batch_iterator
        from repro_torch.models import build_model
        from repro_torch.train import init_train_state, make_train_step

        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.batch = traffic["sequences_per_step"]
        self.seq_len = traffic["seq_len"]
        self.min_steps = traffic["min_steps"]
        self.model_cfg = program_config(cfg, traffic)
        self.arch = {k: cfg[k] for k in reference.ARCH_KEYS}
        self.work_arch = dict(self.arch, **{
            k: cfg[k] for k in ("num_hidden_layers", "intermediate_size",
                                "vocab_size")})
        if traffic["microbatches"] != 1:
            raise ValueError("lm_train pins the routes of one microbatch "
                             "a step")
        hp = cfg["optimizer"]
        self.tcfg = TrainConfig(
            global_batch=self.batch, seq_len=self.seq_len,
            lr=hp["lr"], warmup_steps=hp["warmup_steps"],
            total_steps=hp["total_steps"],
            weight_decay=hp["weight_decay"], grad_clip=hp["grad_clip"],
            microbatches=1, remat=traffic["remat"],
            param_dtype=cfg["param_dtype"], seed=_seed(seed))
        check_rng = np.random.default_rng([_seed(seed), 1])
        #: the early step of the window whose inputs are kept for the
        #: check (its last step is kept too)
        self.sampled_step = int(check_rng.integers(
            0, traffic["check"]["sample_below"]))
        self.flops_per_step = train_work.model_flops_per_step(
            self.work_arch, self.batch, self.seq_len)
        self.model = build_model(self.model_cfg, device=self.device)
        self.state = init_train_state(self.model, self.tcfg.seed, self.tcfg)
        self.step_fn = make_train_step(self.model, self.tcfg)
        self.batches = make_batch_iterator(self.model_cfg, self.tcfg)
        on_card = self.device.type == "cuda"
        #: the parameters' tree, of meta tensors
        self.template = tree_map(lambda p: torch.empty(p.shape,
                                                       device="meta"),
                                 self.state.params)
        numel = sum(p.numel() for p in tree_flatten(self.state.params))
        #: host memory for each kept step's parameters and moments before
        #: it and its parameters after it
        self.slots = [{k: torch.empty(numel, dtype=torch.float32,
                                      pin_memory=on_card)
                       for k in self.KEPT} for _ in range(2)]
        self.side = torch.cuda.Stream(self.device) if on_card else None
        #: steps the state has taken (the optimizer's step count)
        self.taken = 0
        self.kept, self._keeping = {}, {}
        self.trace_rows = None
        t = time.perf_counter()
        self.steps(count=traffic["warm_steps"])
        self._sync()
        #: host seconds of the parts of a run, printed by the check
        self.seconds = {"warm": time.perf_counter() - t}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def moe_bound_s_per_step(self, peaks):
        """Least time a step's K3 and K3w calls could take at ``peaks``
        (``bench/train_work.py``)."""
        return train_work.moe_bound_s_per_step(
            self.work_arch, self.batch, self.seq_len, peaks,
            self.traffic["remat"])

    def launches(self):
        from repro_torch.kernels import moe_gmm

        return moe_gmm.gmm.launches + moe_gmm.gmm_wgrad.launches

    def _keep(self, batch):
        """The parameters and moments before the next step, copied into a
        free slot of host memory (on the side stream, on the card), and
        its batch."""
        slot = self.slots[len(self.kept) + len(self._keeping)]
        state = self.state
        done = self._copy({"params": state.params, "m": state.opt.m,
                           "v": state.opt.v}, slot)
        return {"slot": slot, "batch": batch, "done": [done],
                "step": self.taken}

    def _copy(self, trees, slot):
        """Each tree's leaves into ``slot`` under its name, after the
        device's work so far; the side stream's event, or None off the
        card."""
        from repro_torch.checkpoint.checkpointer import tree_flatten

        side = self.side
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for name, tree in trees.items():
                at = 0
                for p in tree_flatten(tree):
                    n = p.numel()
                    slot[name][at:at + n].view_as(p).copy_(
                        p, non_blocking=True)
                    if side is not None:
                        p.record_stream(side)
                    at += n
        if side is None:
            return None
        done = torch.cuda.Event()
        done.record(side)
        return done

    def steps(self, count=None, seconds=None, keep=()):
        """Run steps until ``count`` have run, or until ``seconds`` have
        passed and ``min_steps`` have run (the step that starts after both
        is the last); returns (steps, host seconds from the first enqueue
        to the last completion, each step's device ms, the kept inputs by
        step: the steps in ``keep`` and, with ``seconds``, the last)."""
        pending, step_ms, i = deque(), [], 0
        self._keeping = {}
        t0 = time.perf_counter()
        while count is None or i < count:
            last = seconds is not None and i + 1 >= self.min_steps \
                and time.perf_counter() - t0 >= seconds
            batch = next(self.batches)
            if i in keep or last:
                self._keeping[i] = self._keep(batch)
            start = _Stamp(self.device).record()
            self.state, metrics = self.step_fn(self.state, batch)
            end = _Stamp(self.device).record()
            self.taken += 1
            if i in self._keeping:
                k = self._keeping[i]
                k["loss"] = metrics["loss"]
                k["done"].append(self._copy({"after": self.state.params},
                                            k["slot"]))
            pending.append((start, end))
            if len(pending) >= self.in_flight:
                self._retire(pending.popleft(), step_ms)
            i += 1
            if last:
                break
        while pending:
            self._retire(pending.popleft(), step_ms)
        kept, self._keeping = self._keeping, {}
        return i, time.perf_counter() - t0, step_ms, kept

    @staticmethod
    def _retire(item, step_ms):
        start, end = item
        end.wait()
        step_ms.append(start.ms_until(end))

    def window(self, seconds):
        """The measured window: a dict of what it counted."""
        self.seconds["window_start"] = time.perf_counter()
        steps, window_s, step_ms, kept = self.steps(
            seconds=seconds, keep={self.sampled_step})
        for k in kept.values():
            for done in k["done"]:
                if done is not None:
                    done.synchronize()
            k["loss"] = float(k["loss"])
        self.kept = kept
        return {"steps": steps, "window_s": window_s, "step_ms": step_ms,
                "samples": steps * self.batch}

    def trace(self):
        """Device ops, busy time and window over ``trace_steps`` steps
        traced on the device alone (with their launch calls, kept for
        ``train_host_idle_share``) after one more; None off the card, and
        None where every try lost operations (fewer K3/K3w kernels than
        were launched, or operations that do not divide into the steps)."""
        if self.device.type != "cuda":
            return None
        count, warm = self.traffic["trace_steps"], train_trace.WARM
        for _ in range(train_trace.TRIES):
            before = self.launches()
            trace = tracing.profile(lambda: self.steps(count=warm + count))
            launched = self.launches() - before
            ops, launches = tracing.read_trace(trace)
            seen = sum(1 for o in ops if o[0] in train_trace.K3_KERNELS[:2]
                       + train_trace.K3W_KERNELS)
            got = tracing.reduce([o[:3] for o in ops], count, skip=warm)
            if seen == launched and got is not None:
                self.trace_rows = (train_trace.kept(ops, count), launches)
                return got
        return None

    def free_program(self):
        """Drop the program's state (parameters, optimizer state, the step
        and the batch stream)."""
        self.batches.close()
        self.state = self.step_fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _tree(self, flat):
        """A flat host buffer on the device, in the parameters' tree."""
        from repro_torch.checkpoint.checkpointer import (tree_flatten,
                                                         tree_unflatten)

        leaves, at = [], 0
        for p in tree_flatten(self.template):
            n = p.numel()
            leaves.append(flat[at:at + n].view(p.shape).to(self.device))
            at += n
        return tree_unflatten(self.template, leaves)

    def _update_rel_err(self, k, params, after, ref_grads):
        """The worst leaf's ||dp - dp_ref|| / ||dp_ref|| of kept step
        ``k``, ``after`` its parameters after the step: dp_ref is the
        reference's AdamW step with ``ref_grads``, from the kept moments;
        and that leaf's name."""
        hp = self.cfg["optimizer"]
        names = reference.leaf_names(ref_grads)
        scale = reference.clip_scale(ref_grads, hp)
        leaves = [reference._leaves(t) for t in (
            params, after, ref_grads, self._tree(k["slot"]["m"]),
            self._tree(k["slot"]["v"]))]
        errs = []
        for name, p, new, g, m, v in zip(names, *leaves):
            want = reference.adamw_leaf(name, p, g, m, v, k["step"], hp,
                                        scale)
            [err] = reference.rel_errors([new.double() - p.double()],
                                         [want.double() - p.double()])
            errs.append(err)
        at = int(np.argmax(errs))
        return errs[at], names[at]

    def _judge(self, program):
        """(worst by name, where, readings by kept step) of ``program(k,
        params)``, which gives for kept step ``k`` (loss, gradients,
        experts by layer, parameters after the step, why not comparable or
        None), against the fp32 reference on the program's routes."""
        t = time.perf_counter()
        names = ("loss_rel_err", "grad_rel_err", "route_gap",
                 "update_rel_err")
        per, worst, where = {}, dict.fromkeys(names, 0.0), {}
        #: each leaf's ||g - g_ref|| / ||g_ref|| by kept step
        self.leaf_errors = {}
        for i, k in sorted(self.kept.items()):
            params = self._tree(k["slot"]["params"])
            loss, grads, routes, after, fault = program(k, params)
            ref = None
            if fault is None:
                try:
                    ref = reference.loss_and_grads(
                        params, k["batch"]["tokens"], k["batch"]["targets"],
                        self.arch, routes=routes)
                except ValueError as e:
                    fault = f"the program's routes: {e}"
            if ref is not None:
                errs = reference.rel_errors(grads, ref.grads)
                leaf = reference.leaf_names(ref.grads)
                self.leaf_errors[i] = dict(zip(leaf, errs))
                at = int(np.argmax(errs))
                update, moved = self._update_rel_err(k, params, after,
                                                     ref.grads)
                got = {"loss_rel_err": abs(loss - ref.loss) / abs(ref.loss),
                       "grad_rel_err": errs[at],
                       "route_gap": ref.route_gap,
                       "update_rel_err": update}
                got = {n: v if v == v else float("inf")
                       for n, v in got.items()}
                said = {"grad_rel_err": f"step {i} {leaf[at]}",
                        "update_rel_err": f"step {i} {moved}"}
            else:
                got = dict.fromkeys(names, float("inf"))
                said = dict.fromkeys(names, f"step {i}: {fault}")
            del params, grads, routes, after, ref
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            per[i] = got
            for n, v in got.items():
                if v >= worst[n]:
                    worst[n], where[n] = v, said.get(n, f"step {i}")
        print(f"lm_train: warm steps {self.seconds['warm']:.1f} s, from the "
              f"window's start to the check {t - self.seconds['window_start']:.1f}"
              f" s, the check {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
        return worst, "; ".join(f"{n} at {w}" for n, w in
                                sorted(where.items())), per

    def check(self, pinned=True):
        """Each kept step recomputed by the program's ``loss_and_grads``,
        its loss equal to the step's bit for bit, against the reference on
        the program's routes (``pinned=False``: on the reference's own,
        for ``bench/train_readings.py``)."""
        from repro_torch.train.trainer import loss_and_grads

        layers = self.cfg["num_hidden_layers"]

        def program(k, params):
            with RouteRecorder() as rec:
                loss, grads = loss_and_grads(self.model, self.tcfg, params,
                                             k["batch"])
            loss = float(loss)
            after = self._tree(k["slot"]["after"])
            fault = None
            if loss != k["loss"]:
                fault = (f"the recomputed loss {loss!r} is not the step's "
                         f"{k['loss']!r}")
            elif len(rec.experts) not in (layers, 2 * layers):
                fault = (f"{len(rec.experts)} routings recorded, want "
                         f"{layers} (and as many again recomputed)")
            routes = rec.experts[:layers] if pinned else None
            return loss, grads, routes, after, fault

        return self._judge(program)

    def control(self):
        """The control in the program's place: the reference with every
        product's inputs rounded through float8 (e4m3), a precision below
        the configuration's bf16, routing on its own logits, and the
        reference's AdamW step from its gradients, on the kept steps'
        parameters, moments and batches."""
        hp = self.cfg["optimizer"]

        def program(k, params):
            got = reference.loss_and_grads(
                params, k["batch"]["tokens"], k["batch"]["targets"],
                self.arch, rounded=reference.float8_inputs)
            after = reference.adamw_step(
                params, got.grads, self._tree(k["slot"]["m"]),
                self._tree(k["slot"]["v"]), k["step"], hp)
            return got.loss, got.grads, got.routes, after, None

        return self._judge(program)


class RouteRecorder:
    """While active, records the experts of each call of the program's
    router (``repro_torch.models.moe._route``'s top-k), in call order; the
    routing itself is the program's."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route, self.experts = moe, moe._route, []

        def route(logits, top_k):
            out = self.route(logits, top_k)
            self.experts.append(out[1].detach().clone())
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route
