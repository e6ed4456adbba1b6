"""The three kinds of cell a traffic mix can ask for (``"kind"`` in its file):
``enhance`` (``Enhancer.enhance_batch`` in a closed loop, one card or a data
mesh of ranks), ``vocode`` (``SDDM_spectrogram.infer`` in a closed loop) and
``train`` (the train step of ``make_train_step``).

Each driver builds the system under test through the program's own
builders from the configuration's file and seeded weights, warms the
cell's shapes, runs the measured window, and afterwards holds what the
window produced against the configuration's plain reference.  The program
is ``sddm_tpu_torch``; nothing here imports it at module level.
"""

from __future__ import annotations

import gc
import time
from math import ceil

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import plain
from benchmark.tracing import Spans


REF_ROWS = 256  # the rows a reference computes at once (a quarter of that with gradients)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Driver:
    """What every kind shares: the cell, the seed, the device, the mesh of
    ranks (None: this process alone), and ``faults``, names of faults
    planted under the timed path (the harness's own tests plant them)."""

    kind = ""

    def __init__(self, cell, seed: int, device, mesh=None, faults=()):
        self.cell, self.seed, self.device, self.mesh = cell, int(seed), torch.device(device), mesh
        self.config, self.traffic, self.ref = cell.config, cell.traffic, cell.reference
        self.faults = set(faults)
        self.spans = Spans()
        self.main = mesh is None or mesh.is_main
        self.n_ranks = 1 if mesh is None else mesh.n_data
        self.forwards = None  # a ForwardCounter while a window is traced

    # the harness calls these, in this order
    def setup(self):
        raise NotImplementedError

    def window(self, seconds: float, stop=None) -> None:
        """Run the closed loop until ``seconds`` have passed (``stop(bool)``
        agrees the decision over the ranks)."""
        raise NotImplementedError

    def end_to_end(self) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state before the reference runs."""

    def checks(self) -> dict:
        """``{name: value}`` of the numbers compared with the reference."""
        raise NotImplementedError

    def done(self) -> int:
        """Calls (or steps) completed so far."""
        return len(self.calls)

    def layer_context(self, n: int) -> dict:
        """What the per-layer readers read besides the trace, for a traced
        window of ``n`` calls (or steps)."""
        raise NotImplementedError

    def trace_wrap(self) -> None:
        """Spans a traced run adds around calls into the program (the
        drivers' windows take their own)."""

    def _elapsed(self, start, seconds, stop) -> bool:
        done = time.perf_counter() - start >= seconds
        return stop(done) if stop is not None else done


def plant_sampler_faults(model, faults) -> None:
    """``step_unchanged``: the sampler's last step returns its state as it
    got it."""
    if "step_unchanged" in faults:
        step = model._reverse_step

        def frozen(sched, condition, x_t, t, *a, **k):
            out = step(sched, condition, x_t, t, *a, **k)
            return x_t if t == 1 else out

        model._reverse_step = frozen


# ---- enhancement -------------------------------------------------------------------
class Enhance(Driver):
    kind = "enhance"

    def setup(self):
        from sddm_tpu_torch.cli import build_arch, build_diffusion, build_network
        from sddm_tpu_torch.enhance import Enhancer
        from sddm_tpu_torch.models.unet_modified2 import UNetModified2
        from sddm_tpu_torch.models.unet_packed import PackedUNetModified2
        from sddm_tpu_torch.parallel.mesh import replicate

        cfg, tr = self.config, self.traffic
        self.num_samples = cfg["num_samples"]
        self.rows = int(tr["batch_rows"])
        self.steps = int(tr["sampler"]["steps"])
        network = build_network(cfg, num_samples=self.num_samples).to(self.device).eval()
        self.params = inputs.seeded_weights(network, self.seed, self.device)
        if self.mesh is not None:
            replicate(network, self.mesh)
        diffusion = build_diffusion(cfg)

        def enhancer_of(net):
            model = build_arch(cfg, diffusion, net).with_sampling_steps(self.steps)
            gen = inputs.generator(self.seed, "noise", self.device)
            return Enhancer(model, self.num_samples, self.rows, generator=gen, mesh=self.mesh)

        # the engine as load_enhancer chooses it (with the configuration's
        # "packed", as infer passes it): a UNetModified2 without dropout
        # through the packed engine, checked by its canary; else the network
        self.engine, self.engine_fallback = network, None
        if cfg.get("packed") and isinstance(network, UNetModified2) and not network.dropout:
            self.engine = PackedUNetModified2(network).eval()
            self.enhancer = enhancer_of(self.engine)
            if not self.enhancer.validate():
                self.engine, self.engine_fallback = network, "canary"
        if self.engine is network:
            self.enhancer = enhancer_of(network)
        self._plant_faults()
        for _ in range(2):
            self.enhancer.warmup()
        self.requests = inputs.EnhanceRequests(tr, self.seed, self.num_samples)
        self.calls = []

    def _plant_faults(self):
        plant_sampler_faults(self.enhancer.model, self.faults)
        if "exchange_left_out" in self.faults:
            import sddm_tpu_torch.enhance as program

            # each rank keeps its own rows where the gather would bring the others'
            program.gather_rows = lambda local, mesh: local.repeat(
                (mesh.n_data,) + (1,) * (local.dim() - 1))
        if "answer_altered" in self.faults:
            batch = self.enhancer.enhance_batch

            def altered(audios):
                outs = batch(audios)
                outs[0] = outs[0][::-1].copy()  # the first answer reversed in time
                return outs

            self.enhancer.enhance_batch = altered

    def window(self, seconds, stop=None):
        enh, gen = self.enhancer, self.enhancer.generator
        start = time.perf_counter()
        while True:
            call = self.requests.next_call()
            state = gen.get_state()
            t0 = time.perf_counter()
            with self.spans("enhance_batch"):
                outs = enh.enhance_batch([a for _, a in call])
            t1 = time.perf_counter()
            self.calls.append({"state": state, "lengths": [a.size for _, a in call],
                               "audio": [a for _, a in call], "outs": outs, "t": t1 - t0})
            if self._elapsed(start, seconds, stop):
                break
        self.window_s = time.perf_counter() - start

    def end_to_end(self) -> dict:
        audio = sum(sum(c["lengths"]) for c in self.calls) / self.config["sample_rate"]
        lat = np.concatenate([[c["t"]] * len(c["lengths"]) for c in self.calls])
        self.attempted = int(lat.size)
        self.failed = sum(1 for c in self.calls for o, n in zip(c["outs"], c["lengths"])
                          if o.size != n or not np.isfinite(o).all())
        return {"serve_audio_s_per_s": audio / self.window_s,
                "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self):
        self.enhancer = self.engine = None
        _free(self.device)

    def _checked_calls(self) -> list:
        """A sample of the window's calls drawn from the seed, with the call
        that holds the longest request."""
        n = min(int(self.traffic["check"]["calls"]), len(self.calls))
        longest = max(range(len(self.calls)), key=lambda i: max(self.calls[i]["lengths"]))
        rng = np.random.default_rng(inputs.stream_seed(self.seed, "check"))
        others = [i for i in range(len(self.calls)) if i != longest]
        picked = rng.choice(others, size=min(n - 1, len(others)), replace=False)
        return sorted({longest, *map(int, picked)})

    def reference_outputs(self, call: dict, prec=None) -> list:
        """The reference's answers to one call: the requests cut into rows of
        ``num_samples`` (zero-padded) in order, the batch padded with zero
        rows to ``batch_rows``, the same draws, each answer trimmed."""
        n, dev = self.num_samples, self.device
        rows = []
        for a in call["audio"]:
            k = ceil(a.size / n)
            padded = np.zeros(k * n, np.float32)
            padded[: a.size] = a
            rows.append(padded.reshape(k, n))
        rows = np.concatenate(rows)
        owner_rows = [ceil(a.size / n) for a in call["audio"]]
        batch = np.zeros((self.rows, 1, n), np.float32)
        batch[: rows.shape[0], 0] = rows
        gen = torch.Generator(device=dev)
        gen.set_state(call["state"])
        shape = (self.rows, 1, n)
        x_T = torch.randn(shape, generator=gen, device=dev)
        steps = [torch.randn(shape, generator=gen, device=dev) for _ in range(self.steps)]
        cond = torch.from_numpy(batch).to(dev)
        out = []
        with plain.strict_float32():  # rows are independent: blocks of rows, so that it fits
            for r0 in range(0, self.rows, REF_ROWS):
                r1 = r0 + REF_ROWS
                out.append(self.ref.enhance(self.params, self.config, cond[r0:r1], x_T[r0:r1],
                                            [s[r0:r1] for s in steps], self.steps, prec).cpu())
        out = torch.cat(out).numpy()[:, 0]
        answers, r = [], 0
        for a, k in zip(call["audio"], owner_rows):
            answers.append(out[r: r + k].reshape(-1)[: a.size])
            r += k
        return answers

    def checks(self) -> dict:
        worst = 0.0
        for i in self._checked_calls():
            call = self.calls[i]
            for got, want in zip(call["outs"], self.reference_outputs(call)):
                if got.shape == want.shape:  # a wrong length is counted below
                    worst = max(worst, rel_l2(torch.from_numpy(got), torch.from_numpy(want)))
        bad = sum(1 for c in self.calls for o, n in zip(c["outs"], c["lengths"]) if o.size != n)
        return {"out_rel_l2_max": worst, "wrong_length": float(bad)}

    def control(self, prec) -> dict:
        """The numbers of :meth:`checks` with the reference under ``prec`` in
        the program's place."""
        worst = 0.0
        for i in self._checked_calls():
            call = self.calls[i]
            for got, want in zip(self.reference_outputs(call, prec), self.reference_outputs(call)):
                worst = max(worst, rel_l2(torch.from_numpy(got), torch.from_numpy(want)))
        return {"out_rel_l2_max": worst, "wrong_length": 0.0}

    def trace_network(self):
        return self.enhancer.model.network

    def trace_wrap(self):
        self.spans.wrap(self.enhancer.model, "infer", "infer")

    def layer_context(self, n: int) -> dict:
        per_rank = self.rows // self.n_ranks if self.enhancer_sharded else self.rows
        return {"kind": self.kind, "calls": n, "forwards": self.forwards.count,
                "flops_per_forward": self.ref.forward_flops(self.config, per_rank)
                * (self.n_ranks if self.enhancer_sharded else 1),
                "flops_per_call": 0,
                "gn_sites": self.ref.norm_sites(self.config, per_rank),
                "element_size": 2 if self.config.get("dtype") == "bfloat16" else 4}

    @property
    def enhancer_sharded(self) -> bool:
        return self.n_ranks > 1 and self.rows % self.n_ranks == 0


# ---- vocoding -----------------------------------------------------------------------
class Vocode(Driver):
    kind = "vocode"

    def setup(self):
        from sddm_tpu_torch.cli import (build_arch, build_diffusion, build_network,
                                        spec_feature_fn, spec_hop_samples)

        cfg, tr = self.config, self.traffic
        self.steps = int(tr["sampler"]["steps"])
        network = build_network(cfg, device=self.device).to(self.device).eval()
        self.params = inputs.seeded_weights(getattr(network, "net", network), self.seed,
                                            self.device)
        hop = spec_hop_samples(cfg, "test_data_loader")
        model = build_arch(cfg, build_diffusion(cfg), network, hop_samples=hop,
                           feature_fn=spec_feature_fn(cfg, hop))
        if tr["sampler"].get("ddim"):
            model = model.with_ddim()
        self.model = model.with_sampling_steps(self.steps)
        self._plant_faults()
        self.requests = inputs.VocodeRequests(tr, self.seed, self.device)
        self.samples = int(tr["frames"]) * hop
        self.batch = int(tr["batch"])
        self.gen = inputs.generator(self.seed, "noise", self.device)
        warm = torch.Generator(device=self.device).manual_seed(0)
        for _ in range(2):
            spec = self.requests.specs[: self.batch]
            x_T = torch.randn((self.batch, 1, self.samples), generator=warm, device=self.device)
            self.model.infer(spec, noise_stream=(x_T, None)).float().cpu()
        self.calls = []

    def _plant_faults(self):
        plant_sampler_faults(self.model, self.faults)
        if "answer_altered" in self.faults:
            infer = self.model.infer

            def altered(*a, **k):
                out = infer(*a, **k).clone()
                out[0] = out[0].flip(-1)  # the first answer reversed in time
                return out

            self.model.infer = altered

    def window(self, seconds, stop=None):
        start = time.perf_counter()
        while True:
            idx = self.requests.next_call()
            state = self.gen.get_state()
            t0 = time.perf_counter()
            spec = self.requests.specs[idx.to(self.device)]
            x_T = torch.randn((self.batch, 1, self.samples), generator=self.gen,
                              device=self.device)
            with self.spans("infer"):
                out = self.model.infer(spec, noise_stream=(x_T, None))
            out = out.float().cpu()
            t1 = time.perf_counter()
            self.calls.append({"state": state, "idx": idx, "out": out, "t": t1 - t0})
            if self._elapsed(start, seconds, stop):
                break
        self.window_s = time.perf_counter() - start

    def end_to_end(self) -> dict:
        sr = self.config["sample_rate"]
        audio = len(self.calls) * self.batch * self.samples / sr
        lat = np.repeat([c["t"] for c in self.calls], self.batch)
        self.attempted = int(lat.size)
        self.failed = sum(int((~torch.isfinite(c["out"]).all(dim=-1).all(dim=-1)).sum())
                          for c in self.calls)
        return {"serve_audio_s_per_s": audio / self.window_s,
                "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3}

    def release(self):
        self.model = None
        _free(self.device)

    def _checked_calls(self):
        n = min(int(self.traffic["check"]["calls"]), len(self.calls))
        rng = np.random.default_rng(inputs.stream_seed(self.seed, "check"))
        return sorted(map(int, rng.choice(len(self.calls), size=n, replace=False)))

    def reference_outputs(self, call, prec=None) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.set_state(call["state"])
        spec = self.requests.specs[call["idx"].to(self.device)]
        x_T = torch.randn((self.batch, 1, self.samples), generator=gen, device=self.device)
        with plain.strict_float32():
            return self.ref.vocode(self.params, self.config, spec, x_T, self.steps, prec).cpu()

    def checks(self) -> dict:
        worst = 0.0
        for i in self._checked_calls():
            call = self.calls[i]
            want = self.reference_outputs(call)
            for got_row, want_row in zip(call["out"], want):
                worst = max(worst, rel_l2(got_row, want_row))
        return {"out_rel_l2_max": worst}

    def control(self, prec) -> dict:
        worst = 0.0
        for i in self._checked_calls():
            call = self.calls[i]
            for a, b in zip(self.reference_outputs(call, prec), self.reference_outputs(call)):
                worst = max(worst, rel_l2(a, b))
        return {"out_rel_l2_max": worst}

    def trace_network(self):
        return self.model.network

    def layer_context(self, n: int) -> dict:
        frames, hop = int(self.traffic["frames"]), int(self.traffic["hop"])
        per_call, per_step = self.ref.forward_flops(self.config, self.batch, frames, hop)
        return {"kind": self.kind, "calls": n, "forwards": self.forwards.count,
                "flops_per_forward": per_step, "flops_per_call": per_call,
                "stack": self.ref.stack_shapes(self.config, self.batch, self.samples),
                "element_size": 2 if self.config.get("dtype") == "bfloat16" else 4}


# ---- training -------------------------------------------------------------------------------
class Train(Driver):
    kind = "train"
    CHECK_STEPS = 3
    # the other numbers are read (``readings``) but not compared: the loss gap
    # and the worst leaf's change gap do not separate the fp8 control from
    # sound runs, the change by small leaves' noise, where the median leaf's
    # does; the gradient's norm gap is never above its relative L2, which a
    # step on half the batch moves where the norm stays (PERF.md, section 4)
    COMPARED = ("grad_rel_l2", "change_norm_gap_median")

    def setup(self):
        from sddm_tpu_torch.cli import (build_arch, build_diffusion, build_loss, build_network,
                                        build_optimizer)
        from sddm_tpu_torch.train.trainer import make_train_step

        cfg, tr = self.config, self.traffic
        self.num_samples = cfg["num_samples"]
        self.rows = int(tr["batch"])
        self.network = build_network(cfg, num_samples=self.num_samples, role="train")
        self.network.to(self.device).train()
        self.params0 = inputs.seeded_weights(self.network, self.seed, self.device)
        self.model = build_arch(cfg, build_diffusion(cfg), self.network)
        self.optimizer = build_optimizer(cfg, self.network)
        self.step = make_train_step(self.model, build_loss(cfg), self.optimizer)
        self.batches = inputs.TrainBatches(tr, self.seed, self.num_samples, self.device)
        self.gen = inputs.generator(self.seed, "noise", self.device)
        self.T = cfg["diffusion"]["args"]["n_timestep"]
        self._plant_faults()
        # the first steps go through the window's own call and feed; the
        # reference follows them
        self.first = []
        self.losses = []
        names = [n for n, _ in self.network.named_parameters()]
        for k in range(self.CHECK_STEPS):
            idx, draws = self._one_step()
            self.first.append((idx, draws))
            if k == 0:  # the first gradient as the optimizer got it: mu / (1 - b1)
                b1 = self.optimizer.defaults["betas"][0]
                self.grads = {n: (self.optimizer.state[p]["mu"].float() / (1 - b1)).cpu()
                              for n, p in zip(names, self.network.parameters())}
        self.change_norms = {n: float((p.detach() - self.params0[n]).norm())
                             for n, p in self.network.named_parameters()}
        self.first_losses = [float(v) for v in self.losses]
        self.losses = []
        self.steps_done = 0

    def _plant_faults(self):
        if "step_unchanged" in self.faults:
            self.optimizer.step = lambda closure=None: None
        if "half_batch" in self.faults:
            forward = self.model.forward

            def half(target, condition, generator=None, draws=None, dropout=None):
                h = target.shape[0] // 2
                d = None if draws is None else tuple(x[:h] for x in draws)
                return forward(target[:h], condition[:h], generator, d, dropout)

            self.model.forward = half

    def _draws(self):
        b, dev = self.rows, self.device
        t = torch.randint(1, self.T + 1, (b,), generator=self.gen, device=dev)
        frac = torch.rand((b,), generator=self.gen, device=dev)
        eps = torch.randn((b, 1, self.num_samples), generator=self.gen, device=dev)
        return t, frac, eps

    def _one_step(self):
        idx = self.batches.next_rows()
        draws = self._draws()
        with self.spans("train_step"):
            loss = self.step(self.batches.clean[idx], self.batches.noisy[idx], draws=draws)
        self.losses.append(loss)
        return idx, draws

    def window(self, seconds, stop=None):
        start = time.perf_counter()
        while True:
            self._one_step()
            self.steps_done += 1
            if self._elapsed(start, seconds, stop):
                break
        _sync(self.device)
        self.window_s = time.perf_counter() - start

    def end_to_end(self) -> dict:
        self.attempted = self.steps_done
        self.failed = int((~torch.isfinite(torch.stack(self.losses))).sum())
        audio = self.steps_done * self.rows * self.num_samples / self.config["sample_rate"]
        return {"train_audio_s_per_s": audio / self.window_s}

    def release(self):
        self.network = self.model = self.optimizer = self.step = None
        self.losses = []
        self.grads = {n: g.to(self.device) for n, g in self.grads.items()}
        _free(self.device)

    def _reference(self, prec=None) -> tuple:
        """The reference's first steps: their losses, the first gradient by
        leaf and the parameters' change's norm after the last, by leaf."""
        params = {k: v.clone().requires_grad_(True) for k, v in self.params0.items()}
        lr = float(self.config["optimizer"]["args"]["lr"])
        opt = plain.AmsGrad(params, lr)
        losses, first = [], {}
        with plain.strict_float32():
            for k, (idx, (t, frac, eps)) in enumerate(self.first):
                # the batch's mean loss as a sum over blocks of rows, so that it fits
                loss, grads = 0.0, {n: torch.zeros_like(p) for n, p in params.items()}
                for r0 in range(0, len(idx), REF_ROWS // 4):
                    b = slice(r0, r0 + REF_ROWS // 4)
                    part = self.ref.train_loss(params, self.config, self.batches.clean[idx[b]],
                                               self.batches.noisy[idx[b]], t[b], frac[b],
                                               eps[b], prec) * (len(idx[b]) / len(idx))
                    for n, g in zip(params, torch.autograd.grad(part, list(params.values()))):
                        grads[n] += g
                    loss += float(part.detach())
                if k == 0:
                    first = {n: g.clone() for n, g in grads.items()}
                opt.step(grads)
                losses.append(loss)
        change = {n: float((p.detach() - self.params0[n]).norm()) for n, p in params.items()}
        return losses, first, change

    @staticmethod
    def _gaps(losses, grads, change, ref) -> dict:
        """Each step's loss against the reference's, and by leaf the first
        gradient and the change's norm against the reference's: the gap of
        the gradient's norm, the gradient's relative L2 (the norm of the
        difference) and the gap of the change's norm, each over the
        reference's norm of the leaf or of the median leaf, whichever is
        larger.  Leaves whose reference gradient is under a thousandth of the
        median leaf's are left out (they move by round-off alone).  The
        worst leaf's number, and the median leaf's."""
        r_losses, r_grads, r_change = ref
        r_norms = {n: float(g.norm()) for n, g in r_grads.items()}
        med_g = float(np.median(list(r_norms.values())))
        moved = [n for n in r_norms if r_norms[n] >= 1e-3 * med_g]
        med_c = float(np.median([r_change[n] for n in moved]))
        scale = {n: max(r_norms[n], med_g) for n in moved}
        g = {n: abs(float(grads[n].norm()) - r_norms[n]) / scale[n] for n in moved}
        d = {n: float((grads[n] - r_grads[n]).norm()) / scale[n] for n in moved}
        c = {n: abs(change[n] - r_change[n]) / max(r_change[n], med_c) for n in moved}
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "grad_norm_gap": max(g.values()), "grad_norm_gap_median": float(np.median(list(g.values()))),
            "grad_rel_l2": max(d.values()), "grad_rel_l2_median": float(np.median(list(d.values()))),
            "change_norm_gap": max(c.values()),
            "change_norm_gap_median": float(np.median(list(c.values()))),
            "worst_grad_leaf": max(g, key=g.get), "worst_grad_l2_leaf": max(d, key=d.get),
            "worst_change_leaf": max(c, key=c.get),
        }

    def readings(self) -> dict:
        """Every candidate number (:meth:`_gaps`), compared or not."""
        return self._gaps(self.first_losses, self.grads, self.change_norms,
                          self._reference())

    def checks(self) -> dict:
        gaps = self.readings()
        return {k: gaps[k] for k in self.COMPARED}

    def control(self, prec) -> dict:
        return self._gaps(*self._reference(prec), self._reference())

    def trace_network(self):
        return self.network

    def done(self) -> int:
        return self.steps_done

    def layer_context(self, n: int) -> dict:
        return {"kind": self.kind, "steps": n, "forwards": self.forwards.count,
                "flops_per_step": self.ref.forward_flops(self.config, self.rows, backward=True),
                "gn_sites": self.ref.norm_sites(self.config, self.rows),
                "element_size": 2 if self.config.get("dtype") == "bfloat16" else 4}


KINDS = {"enhance": Enhance, "vocode": Vocode, "train": Train}
