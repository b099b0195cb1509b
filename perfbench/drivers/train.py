"""Closed-loop training steps on rows resident on the device.

Set-up builds the training state once: the job from the configuration,
`train.loop.init_state` on the device, the benchmark's weights from the
seed loaded into it, and the step of `train.step.make_train_step`.  The
rows live on the device as (batches, batch rows, ...) blocks, and each
step takes one whole block in a seeded order, as the loop's resident tier
slices them.  The first `checked_steps` steps run through that same step
on the same blocks; the gradient of the first is read from the
optimizer's first moment after it, and the weights after the last; then
`warm_steps` more, and the window runs steps until `seconds` have passed.

After the window (and the traced segment), the program's state is freed
and the reference trains from the same weights on the same checked
batches (`reference.ft_transformer.train`), in float32, and takes the
gradients of the first batch's two halves, whose difference is the
sampling noise that `grad_noise` is measured in.
"""

from __future__ import annotations

import os

from ..core import compare, inputs, trace
from ..core.session import Session
from ..reference import ft_transformer as ref_model


def job_config(cfg: dict, traffic: dict, seed: int):
    """The port's JobConfig for a configuration file and traffic mix."""
    from shifu_tpu_torch.config.schema import (ColumnSpec, DataConfig,
                                               DataSchema, JobConfig,
                                               ModelSpec, OptimizerConfig,
                                               TrainConfig)
    f = cfg["n_num_features"]
    cols = tuple(ColumnSpec(index=i, name=f"x{i}", is_selected=True)
                 for i in range(f))
    schema = DataSchema(
        columns=cols + (ColumnSpec(index=f, name="label", is_target=True),),
        target_index=f, selected_indices=tuple(range(f)))
    spec = ModelSpec(
        model_type=cfg["model_type"], num_layers=cfg["num_layers"],
        token_dim=cfg["token_dim"],
        num_attention_heads=cfg["num_attention_heads"],
        mlp_ratio=cfg["mlp_ratio"], dropout_rate=cfg["dropout_rate"],
        fused_block=cfg["fused_block"], compute_dtype=cfg["compute_dtype"],
        param_dtype=cfg["param_dtype"], num_heads=cfg["num_heads"],
        head_names=tuple(f"shifu_output_{i}"
                         for i in range(cfg["num_heads"])))
    opt = cfg["optimizer"]
    train = TrainConfig(loss=cfg["loss"], seed=int(seed), optimizer=(
        OptimizerConfig(name=opt["name"], learning_rate=opt["learning_rate"],
                        weight_decay=opt["weight_decay"])))
    return JobConfig(schema=schema, model=spec, train=train,
                     data=DataConfig(batch_size=traffic["batch_rows"])
                     ).validate()


def _first_moment(state) -> list:
    """The Adam first moment of every parameter, from the optimizer's
    state: the (count, mu, nu) entry of its chain."""
    n = len(state.optimizer.params)

    def find(node):
        if (isinstance(node, tuple) and len(node) == 3
                and isinstance(node[0], int) and isinstance(node[1], list)
                and len(node[1]) == n):
            return node[1]
        if isinstance(node, (list, tuple)):
            for child in node:
                got = find(child)
                if got is not None:
                    return got
        if isinstance(node, dict):
            for child in node.values():
                got = find(child)
                if got is not None:
                    return got
        return None

    mu = find(state.optimizer.state)
    if mu is None:
        raise RuntimeError("the optimizer's state holds no Adam moments")
    return mu


class Trainer:
    """The program's training state and its feed, built from the seed."""

    def __init__(self, s: Session):
        from shifu_tpu_torch.train.loop import init_state
        from shifu_tpu_torch.train.step import make_train_step

        cfg, traffic = s.config, s.traffic
        dev = s.device
        self.cfg = cfg
        self.b = traffic["batch_rows"]
        rows = traffic["rows"]
        self.n_batches = rows // self.b
        s.mark("imports")
        x = inputs.numeric_rows(rows, cfg["n_num_features"], s.seed, dev)
        y = inputs.teacher_labels(x, s.seed, traffic["teacher_hidden"])
        used = self.n_batches * self.b
        self.features = x[:used].view(self.n_batches, self.b, -1)
        self.target = y[:used].view(self.n_batches, self.b, 1)
        self.order = inputs.batch_order(s.seed, self.n_batches)
        self.weights = inputs.ft_weights(cfg, s.seed, dev)
        s.sync()
        s.mark("inputs")
        self.job = job_config(cfg, traffic, s.seed)
        self.state = init_state(self.job, cfg["n_num_features"], device=dev)
        self.state.model.load_state_dict(self.weights)
        self.names = [n for n, _ in self.state.model.named_parameters()]
        self.step_fn = make_train_step(self.job)
        self.steps = 0
        s.mark("state")

    def batch(self, i: int) -> dict:
        idx = int(self.order[i % self.n_batches])
        return {"features": self.features[idx], "target": self.target[idx]}

    def step(self):
        self.state, out = self.step_fn(self.state, self.batch(self.steps))
        self.steps += 1
        return out

    def checked_steps(self, n: int) -> dict:
        """The first `n` steps, with what the comparison reads: each loss,
        the first gradient (Adam's first moment after step 1 over 1 - b1)
        and the weights after step n."""
        b1 = self.cfg["optimizer"]["b1"]
        losses, grads = [], None
        for _ in range(n):
            losses.append(self.step()["loss"])
            if grads is None:
                grads = {k: (m / (1.0 - b1)).detach().clone() for k, m in
                         zip(self.names, _first_moment(self.state))}
        params = {k: p.detach().clone()
                  for k, p in self.state.model.named_parameters()}
        return {"losses": [float(v) for v in losses], "grads": grads,
                "params": params}

    def checked_batches(self, n: int) -> list:
        return [(self.features[int(self.order[i])].clone(),
                 self.target[int(self.order[i])].clone()) for i in range(n)]


def reference(p0: dict, batches: list, cfg: dict) -> tuple[dict, dict]:
    """The reference's training over `batches`, and the sampling noise of
    the first batch: its two halves' gradients' difference (float32)."""
    x, y = batches[0]
    h = x.shape[0] // 2
    noise_a = ref_model.gradient(p0, x[:h], y[:h], cfg)
    noise_b = ref_model.gradient(p0, x[h:], y[h:], cfg)
    noise = {k: noise_a[k] - noise_b[k] for k in noise_a}
    return ref_model.train(p0, batches, cfg, "f32"), noise


def run(s: Session) -> dict:
    traffic = s.traffic
    t = Trainer(s)
    n_checked = traffic["checked_steps"]
    program = t.checked_steps(n_checked)
    batches = t.checked_batches(n_checked)
    s.mark("checked_steps")
    for _ in range(traffic["warm_steps"]):
        t.step()
    s.sync()
    s.mark("warm_steps")
    t0 = s.now()
    setup_s = t0 - s.t_start
    n = 0
    while True:
        t.step()
        n += 1
        if s.now() - t0 >= s.seconds:
            break
    s.sync()
    window_s = s.now() - t0

    reduced = None
    if s.trace:
        def segment():
            t1 = s.now()
            while s.now() - t1 < traffic["trace_seconds"]:
                t.step()
        reduced = trace.capture(segment, os.path.join(s.tmpdir,
                                                      "trace.json"), s.sync)
    peak = s.memory_peak_bytes()
    p0 = {k: v for k, v in t.weights.items()}
    del t
    s.free()

    ref, noise = reference(p0, batches, s.config)
    gaps = compare.train_gaps(program, ref, p0, noise)
    return {"setup_s": setup_s, "window_s": window_s, "steps": n,
            "samples": n * traffic["batch_rows"], "attempted": n,
            "failed": 0, "memory_peak_bytes": peak, "trace": reduced,
            "readings": gaps}


def readings(s: Session) -> dict:
    """The numbers the limits are set from, for one seed: the program's
    checked steps, the control (the reference in fp8 in the program's
    place) and the fault of half of each batch left out, planted in the
    reference; each against the float32 reference.  No window."""
    n_checked = s.traffic["checked_steps"]
    t = Trainer(s)
    program = t.checked_steps(n_checked)
    batches = t.checked_batches(n_checked)
    p0 = {k: v for k, v in t.weights.items()}
    del t
    s.free()
    ref, noise = reference(p0, batches, s.config)
    control = ref_model.train(p0, batches, s.config, "fp8")
    half = [(x[:x.shape[0] // 2], y[:y.shape[0] // 2]) for x, y in batches]
    half_batch = ref_model.train(p0, half, s.config, "f32")
    out = {side: compare.train_gaps(got, ref, p0, noise) for side, got in
           (("program", program), ("control", control),
            ("half_batch", half_batch))}
    out["ref_losses"] = ref["losses"]
    out["program_losses"] = program["losses"]
    return out
