"""Faults planted in the port underneath a run, to show that the
correctness check catches them (benchmark/tests/test_bench_faults.py on the
CPU; `python -m benchmark.control --fault <name>` reads them on the card).
Each is a context manager that patches the port, never the reference:

  stale_state    the step returns its state unchanged: serving, neither
                 the previous-frames ring nor the frame count advances, so
                 every frame is served as a clip's first; training,
                 neither optimizer steps
  half_batch     half of the batch left out: serving, the second half of
                 the streams gets the first half's frames where the
                 generator's frames are produced; training,
                 the second half of the batch's rows is the first half's,
                 so every mean is taken over the first half alone
  altered_frame  serving: stream 0's frame altered where it is produced
                 (before the previous-frames ring takes it): mirrored left
                 to right, as a layout slip would leave it
  altered_b2     training: kernel B2's cost volume altered where it is
                 produced, for the FlowNet2 teacher: its displacements off
                 by one, as a slip in the kernel's layout would leave them

The cells run on one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import contextlib
from unittest import mock

SERVE = ("stale_state", "half_batch", "altered_frame")
TRAIN = ("stale_state", "half_batch", "altered_b2")


@contextlib.contextmanager
def planted(kind: str, name: str):
    """Fault `name` in the port for traffic of `kind` ("serve" or "train")."""
    if kind == "serve":
        with _serve(name):
            yield
    elif kind == "train":
        with _train(name):
            yield
    else:
        raise ValueError(f"traffic kind {kind!r}")


def _serve(name: str):
    from fsvid2vid_tpu_torch.inference import pipeline
    if name == "stale_state":
        step = pipeline.InferencePipeline.step

        def stale_state(self, label):
            prevs, t = self.prevs, self.t
            out = step(self, label)
            self.prevs, self.t = prevs, t
            return out
        return mock.patch.object(pipeline.InferencePipeline, "step", stale_state)
    synth = pipeline._Runner.synth

    def half_batch(fake):
        half = fake.shape[0] // 2
        fake[half:2 * half] = fake[:half].clone()

    def altered_frame(fake):
        fake[0] = fake[0].flip(1)

    change = {"half_batch": half_batch, "altered_frame": altered_frame}[name]

    def faulty(self, *args, **kw):
        out = synth(self, *args, **kw)
        fake = out["img_final"].clone()
        change(fake)
        return dict(out, img_final=fake)
    return mock.patch.object(pipeline._Runner, "synth", faulty)


def _train(name: str):
    import fsvid2vid_tpu_torch.training.step as step_mod
    import fsvid2vid_tpu_torch.training.trainer as trainer_mod

    if name == "stale_state":
        def no_update(opt, total):
            opt.zero_grad(set_to_none=True)
            total.backward()
        return mock.patch.object(step_mod, "_update", no_update)
    if name == "half_batch":
        step = trainer_mod.train_step

        def halved(x):
            if hasattr(x, "shape") and x.dim() > 0:
                half = x.shape[0] // 2
                x = x.clone()
                x[half:2 * half] = x[:half]
            elif isinstance(x, list):
                x = [halved(v) for v in x]
            return x

        def half_batch(cfg, state, batch, prevs, flags, **kw):
            return step(cfg, state, {k: halved(v) for k, v in batch.items()},
                        prevs, flags, **kw)
        return mock.patch.object(trainer_mod, "train_step", half_batch)
    if name == "altered_b2":
        import fsvid2vid_tpu_torch.models.flownet.flownet2 as flownet2
        correlation = flownet2.correlation

        def altered_b2(*args, **kw):
            return correlation(*args, **kw).roll(1, dims=1)
        return mock.patch.object(flownet2, "correlation", altered_b2)
    raise ValueError(f"training fault {name!r}")
