"""``repro_torch.trace``: the program's spans, off unless a recorder is
installed.

- With no recorder, ``span`` returns one shared null context and calls
  nothing;
- a reduced Mixtral ``make_train_step`` (remat on and off, one and two
  microbatches, CPU) gives bit-identical parameters, moments and metrics
  with a recording sink installed and without one;
- under the sink the step emits each span the number of times its
  microbatches, layers and remat give, every begin matched by its end,
  properly nested, each span inside the one it belongs to;
- a span ends when an exception leaves it, and when a non-reentrant
  ``torch.utils.checkpoint`` stops its recomputation early inside it;
- on the card (``gpu``), a recorder that queues a marker kernel at each
  edge adds no host synchronisation to a step.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch import trace  # noqa: E402
from repro_torch.configs.mixtral_8x7b import reduced  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402

TPGF = ("tpgf.client_forward", "tpgf.local_head", "tpgf.server",
        "tpgf.client_backward", "tpgf.fuse", "tpgf.merge")
# the span each span runs inside; the MoE spans run inside whichever of
# the forward or backward spans ran their layer
PARENT = {"train.step": None, "train.microbatch": "train.step",
          "train.accumulate": "train.step", "optim.apply": "train.step",
          **{n: "train.microbatch" for n in TPGF},
          "moe.route": ("tpgf.client_forward", "tpgf.server",
                        "tpgf.client_backward"),
          "moe.experts": ("tpgf.client_forward", "tpgf.server",
                          "tpgf.client_backward")}


class Sink:
    """A recorder that keeps its calls."""

    def __init__(self):
        self.events = []

    def begin(self, name):
        self.events.append((name, "b"))

    def end(self, name):
        self.events.append((name, "e"))

    def spans(self):
        """Each span as (name, its parent's name), checking that every
        begin is matched by its end and that they nest."""
        stack, out = [], []
        for name, kind in self.events:
            if kind == "b":
                out.append((name, stack[-1] if stack else None))
                stack.append(name)
            else:
                assert stack and stack[-1] == name, (name, stack)
                stack.pop()
        assert not stack, stack
        return out


@pytest.fixture
def sink():
    s = Sink()
    trace.install(s)
    try:
        yield s
    finally:
        trace.install(None)


def test_no_recorder_returns_the_shared_null_context():
    trace.install(None)
    a, b = trace.span("train.step"), trace.span("optim.apply")
    assert a is b
    with a as got:
        assert got is None
    s = Sink()
    trace.install(s)
    trace.install(None)
    with trace.span("train.step"):
        pass
    assert s.events == []


def test_exception_inside_a_span_ends_it(sink):
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError("leaves both spans")
    assert sink.events == [("outer", "b"), ("inner", "b"), ("inner", "e"),
                           ("outer", "e")]


def test_checkpoint_recompute_stopped_early_ends_its_span(sink):
    from torch.utils.checkpoint import checkpoint
    reached = []

    def f(x):
        with trace.span("a"):
            y = x.sin()
        with trace.span("b"):
            z = y.cos()            # saves y, the last tensor saved
            reached.append(True)   # not reached by the recomputation
        return z * 2

    x = torch.randn(5, requires_grad=True)
    checkpoint(f, x, use_reentrant=False).sum().backward()
    assert len(reached) == 1       # the recomputation stopped inside "b"
    assert [n for n, _ in sink.spans()] == ["a", "b", "a", "b"]
    assert torch.allclose(x.grad, -2 * torch.sin(torch.sin(x))
                          * torch.cos(x))


CASES = [(True, 2), (False, 1)]


def _setup(remat, mb):
    cfg = reduced().replace(remat=remat, microbatches=mb)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    step, opt = make_train_step(cfg, adamw(1e-3, weight_decay=0.1))
    return cfg, params, opt.init(params), batch, step


def _run(remat, mb, recorder):
    cfg, params, state, batch, step = _setup(remat, mb)
    trace.install(recorder)
    try:
        for _ in range(2):
            params, state, metrics = step(params, state, batch)
    finally:
        trace.install(None)
    return params, state, metrics


def _leaves(tree):
    return [(p, x) for p, x in tree_flatten_with_path(tree)
            if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("remat,mb", CASES)
def test_step_is_bit_identical_with_a_recorder(remat, mb):
    plain = _run(remat, mb, None)
    traced = _run(remat, mb, Sink())
    for a, b in zip(plain, traced):
        la, lb = _leaves(a), _leaves(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), path


def expected_counts(cfg):
    """Each span's count in one step: the microbatches, and the MoE
    layers' forward runs, once each and, under remat, once more in every
    backward pass through them (the client prefix's two, the server
    suffix's one)."""
    mb, d, L = max(cfg.microbatches, 1), cfg.resolved_split_depth, \
        cfg.n_layers
    runs = d * (1 + 2 * cfg.remat) + (L - d) * (1 + cfg.remat)
    counts = {"train.step": 1, "optim.apply": 1, "train.microbatch": mb,
              "moe.route": mb * runs, "moe.experts": mb * runs,
              **{n: mb for n in TPGF}}
    if mb > 1:
        # each microbatch's add (the first also makes the zeros), and the
        # final cast
        counts["train.accumulate"] = mb + 1
    return counts


@pytest.mark.parametrize("remat,mb", CASES)
def test_step_spans_count_and_nest(sink, remat, mb):
    cfg, params, state, batch, step = _setup(remat, mb)
    step(params, state, batch)
    spans = sink.spans()
    counts = {}
    for name, parent in spans:
        counts[name] = counts.get(name, 0) + 1
        want = PARENT[name]
        assert parent == want or (isinstance(want, tuple)
                                  and parent in want), (name, parent)
    assert counts == expected_counts(cfg)
    if remat:
        # the recomputed layers' MoE spans nest inside the backward spans
        inside = {p for n, p in spans if n == "moe.experts"}
        assert inside == {"tpgf.client_forward", "tpgf.server",
                          "tpgf.client_backward"}



class MarkerSink(Sink):
    """A recorder that also queues a marker kernel at each edge, as one
    that places the spans on the device's clock does."""

    def begin(self, name):
        super().begin(name)
        torch.cuda._sleep(1)

    def end(self, name):
        super().end(name)
        torch.cuda._sleep(1)


@pytest.mark.gpu
def test_marker_recorder_adds_no_host_synchronisation():
    """A reduced remat step with no recorder and one with a marker
    recorder, under ``set_sync_debug_mode("warn")``: the same
    synchronisations, by the program function that makes each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import traceback
    import warnings
    cfg = reduced().replace(remat=True, microbatches=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=g)
    batch = {"tokens": tokens.cuda(),
             "labels": torch.roll(tokens, -1, dims=1).cuda()}
    step, opt = make_train_step(cfg, adamw(1e-3, weight_decay=0.1))
    state = opt.init(params)
    params, state, _ = step(params, state, batch)   # warm-up
    torch.cuda.synchronize()
    syncs = {}

    def run(key, fn):
        found = syncs.setdefault(key, [])

        def note(message, *args, **kw):
            if "called a synchronizing CUDA operation" in str(message):
                frames = [f.name for f in traceback.extract_stack()
                          if "repro_torch" in f.filename]
                found.append(frames[-1] if frames else None)
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    run("probe", lambda: torch.ones(1, device="cuda").item())
    assert syncs["probe"] == [None]        # the watch sees a sync
    sink = MarkerSink()
    for recorder in (None, sink):
        def one_step():
            trace.install(recorder)
            try:
                step(params, state, batch)
            finally:
                trace.install(None)
        run(recorder is not None, one_step)
    assert syncs[True] == syncs[False]
    counts = {}
    for name, _ in sink.spans():
        counts[name] = counts.get(name, 0) + 1
    assert counts == expected_counts(cfg)


def test_backward_point_marks_the_backward_and_adds_nothing_unrecorded():
    x = torch.randn(4, requires_grad=True)
    w = torch.randn(4, requires_grad=True)
    trace.install(None)
    assert trace.backward_point("r.backward.end", x) is x
    s = Sink()
    trace.install(s)
    try:
        with torch.no_grad():
            assert trace.backward_point("r.backward.end", x) is x
        a, b = trace.backward_point("r.backward.end", x, w)
        with trace.span("r"):
            y = trace.backward_point("r.backward.begin", (a * b).sin())
        y.sum().backward()
    finally:
        trace.install(None)
    # the forward span, then the backward's two empty spans in order
    assert [n for n, _ in s.spans()] == ["r", "r.backward.begin",
                                         "r.backward.end"]
    assert torch.equal(x.grad, torch.cos(x * w) * w)
