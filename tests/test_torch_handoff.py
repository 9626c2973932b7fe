"""InferencePipeline.step hands its frame to the host itself
(fsvid2vid_tpu_torch/inference/pipeline.py `hand_off`).  On the CPU the
frame is the generator's own, returned as it is.  On a CUDA card (marker
`cuda`, skipped without one) it comes back page-locked, laid out and valued
as `.cpu()` gives it, complete when the step returns, and in storage of its
own that later steps leave alone; the previous-frames ring stays on the
card.  The file imports neither JAX nor the JAX package and needs no
conftest, so that the card runs it alone:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_handoff.py
"""
import numpy as np
import pytest
import torch

from fsvid2vid_tpu_torch.config import face_config
from fsvid2vid_tpu_torch.inference import pipeline
from fsvid2vid_tpu_torch.models import build_generator

SIZE, STREAMS = 32, 2
TINY = dict(ngf=4, nff=4, ndf=4, fine_size=SIZE, load_size=SIZE, n_blocks_F=2,
            n_downsample_G=3, n_adaptive_layers=2, compute_dtype="float32")


@pytest.fixture(autouse=True)
def two_threads():
    """Tiny networks in several pytest workers at once: two threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the page-locked hand-off runs only there")
    return torch.device("cuda")


def served(device, monkeypatch, steps=3):
    """A tiny K = 1 face pipeline on `device`, reset; its step's labels; and
    the list to which every synth call appends its device frame."""
    cfg = face_config(batch_size=STREAMS, n_shot=1, is_train=False, **TINY)
    torch.manual_seed(0)
    pipe = pipeline.InferencePipeline(cfg, build_generator(cfg, device=str(device)))
    made = []
    synth = pipeline._Runner.synth

    def keep(self, *args, **kw):
        out = synth(self, *args, **kw)
        made.append(out["img_final"])
        return out
    monkeypatch.setattr(pipeline._Runner, "synth", keep)
    rng = np.random.RandomState(1)
    mk = lambda *s: rng.randn(*s).astype(np.float32)
    labels = mk(steps + 1, STREAMS, SIZE, SIZE, 1)
    pipe.reset(mk(STREAMS, 1, SIZE, SIZE, 1), np.tanh(mk(STREAMS, 1, SIZE, SIZE, 3)),
               labels[0])
    return pipe, labels[1:], made


def routes_since(before):
    return {k: v - before[k] for k, v in pipeline.hand_off.calls_by_route.items()}


def test_cpu_step_returns_the_generators_frame_in_place(monkeypatch):
    pipe, labels, made = served("cpu", monkeypatch)
    before = dict(pipeline.hand_off.calls_by_route)
    for t, label in enumerate(labels, 1):
        frame = pipe.step(label)["fake_image"]
        assert frame.data_ptr() == made[-1].data_ptr() and torch.equal(frame, made[-1])
        assert torch.equal(pipe.prevs["fake"][..., -3:], made[-1])
        assert routes_since(before) == {"pinned": 0, "in_place": t}


@pytest.mark.cuda
def test_cuda_step_hands_a_complete_page_locked_frame_of_its_own(cuda, monkeypatch):
    pipe, labels, made = served(cuda, monkeypatch)
    before = dict(pipeline.hand_off.calls_by_route)
    served_frames = []
    for t, label in enumerate(labels, 1):
        frame = pipe.step(label)["fake_image"]
        # nothing left in flight on the step's stream: the copy was waited for
        assert torch.cuda.current_stream(cuda).query()
        dev = made[-1]
        assert dev.is_cuda and pipe.prevs["fake"].is_cuda
        assert frame.device.type == "cpu" and frame.is_pinned()
        want = dev.cpu()
        assert frame.dtype == want.dtype == torch.float32
        assert frame.shape == want.shape == dev.shape
        assert frame.stride() == want.stride() == dev.stride()
        assert torch.equal(frame, want)
        assert routes_since(before) == {"pinned": t, "in_place": 0}
        served_frames.append((frame, want))
    # the frames of steps 1 and 2, after the later steps: each its own storage
    assert len({f.data_ptr() for f, _ in served_frames}) == len(served_frames)
    for frame, want in served_frames:
        assert torch.equal(frame, want)
