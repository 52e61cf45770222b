"""The sanitizer mode in the port (``Engine(sanitize=True)``), after the
JAX package's ``tests/test_sanitize.py`` and at its setting (``_cfg``:
reduced ViT, 4 layers, d_model 48; seed 0, lr 0.3, batch 8).

Held against the live reference (built in a module fixture, never its
goldens): an injected NaN is caught in the kernel the reference names
(``step_kernel`` for FedAvg, ``cohort_kernel`` for ``ssfl`` and ``sfl``)
with the reference's slots. The reference's slots index its padded
bucket, so positions past the cohort's clients are padding, which the
port does not have (departure (b)): its ``_nonfinite_slots`` reads
every leaf whose leading dimension equals the bucket, and at 4 layers
and a 4-slot bucket the server stack's rows count as slots too. The
port's slots are the reference's that hold a client.

Held within the port: an unsanitized run carries the NaN into the loss;
a float trip leaves the cohort's outputs in the engine's state
(departure (g)); an out-of-bounds or negative batch index trips the
host-side gather guard, and the next round runs; a healthy sanitized
run is bit for bit the unsanitized one (the float check only reads);
``sanitize=False`` is bit for bit the default engine and enters no
dispatch mode; the float check catches a NaN that a later ``where``
masks out and a division by zero, and passes an exception raised inside
a step through as itself.

No counterpart here: ``TestAccounting`` counts XLA compiles of the
checkified kernels, and the port compiles nothing per cohort.
``TestMeshSmoke``'s counterpart, the sanitizer on a fleet mesh (healthy
rounds against the meshless engine, and a NaN trip raised on every rank
with the client's global cohort position), is in
``tests/test_torch_multidevice.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from torch.utils._python_dispatch import (  # noqa: E402
    _get_current_dispatch_mode)

from repro.configs import base as JB  # noqa: E402
from repro.federated import Engine as JEngine  # noqa: E402
from repro.federated.bucketing import (  # noqa: E402
    SlotSanitizerError as JSlotSanitizerError)

from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.federated import Engine as TEngine  # noqa: E402
from repro_torch.federated.sanitize import (  # noqa: E402
    FloatCheck, SlotSanitizerError, guard_gather, nonfinite_slots)
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(n_layers=4, d_model=48, n_heads=4, n_kv_heads=4, head_dim=12,
             d_ff=96, image_size=16, n_classes=6)
ARGS = dict(seed=0, lr=0.3, local_steps=2, batch_size=8)
# (strategy, engine arguments, poisoned client): test_sanitize.py's cases
POISON = {"fedavg": ({}, 3),
          "ssfl": (dict(n_clients=4, local_steps=1, batch_size=4), 2),
          "sfl": (dict(n_clients=4, local_steps=1, batch_size=4), 2)}


def _engine(method="ssfl", **kw):
    args = dict(ARGS, **kw)
    n = args.pop("n_clients", 5)
    return TEngine(TB.get_reduced("vit16_cifar").replace(**SMALL), n,
                   method, device="cpu", **args)


@pytest.fixture(scope="module")
def reference():
    """The reference's trip for each poisoned case: (slots, message)."""
    out = {}
    for method, (kw, client) in POISON.items():
        args = dict(ARGS, **kw)
        n = args.pop("n_clients", 5)
        eng = JEngine(JB.get_reduced("vit16_cifar").replace(**SMALL), n,
                      method, sanitize=True, **args)
        eng.data["clients"][client].images[:] = np.nan
        with pytest.raises(JSlotSanitizerError) as exc:
            eng.run_round()
        out[method] = (exc.value.slots, str(exc.value))
    return out


def _poisoned_trip(method):
    kw, client = POISON[method]
    eng = _engine(method, sanitize=True, **kw)
    eng.data["clients"][client].images[:] = np.nan
    with pytest.raises(SlotSanitizerError) as exc:
        eng.run_round()
    depths = eng.state.fleet.depths
    cohort = np.flatnonzero(depths == depths[client])
    return exc.value, cohort, int(np.flatnonzero(cohort == client)[0])


# ------------------------------------------------------- NaN attribution

def test_fedavg_nan_is_caught_with_the_offending_slot(reference):
    # FedAvg runs ONE cohort of all clients at availability 1.0, so
    # position i holds client i
    err, _, pos = _poisoned_trip("fedavg")
    assert err.slots == (3,) == (pos,)
    assert err.slots == reference["fedavg"][0]
    assert "nan" in str(err).lower()
    assert "step_kernel" in str(err)
    assert "step_kernel" in reference["fedavg"][1]


@pytest.mark.parametrize("method", ["ssfl", "sfl"])
def test_split_strategy_nan_slots_match_the_reference(reference, method):
    err, cohort, pos = _poisoned_trip(method)
    ref_slots, ref_msg = reference[method]
    assert "cohort_kernel" in str(err) and "cohort_kernel" in ref_msg
    assert "nan" in str(err).lower()
    # one local step: the NaN reaches only the poisoned client's outputs
    # (and the shared server, which is no slot of the port's)
    assert err.slots == (pos,)
    assert err.slots == tuple(s for s in ref_slots if s < len(cohort))


def test_departure_g_a_float_trip_leaves_the_cohorts_outputs_in_the_state():
    # the port's strategies write a cohort's outputs in place and the check
    # reads after the step: the poisoned client's local head is in the
    # engine's state, NaN (the reference raises before its strategy reads
    # the kernel's outputs)
    kw, client = POISON["ssfl"]
    eng = _engine("ssfl", sanitize=True, **kw)
    eng.data["clients"][client].images[:] = np.nan
    with pytest.raises(SlotSanitizerError):
        eng.run_round()
    assert not all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(eng.state.head_for(client)))


def test_unsanitized_run_propagates_silently():
    eng = _engine("ssfl", n_clients=4, local_steps=1, batch_size=4)
    eng.data["clients"][2].images[:] = np.nan
    assert np.isnan(eng.run_round()["loss"])


# ---------------------------------------------------------- gather guard

@pytest.mark.parametrize("bad", [10_000_000, -1],
                         ids=["past-the-end", "negative"])
def test_out_of_bounds_batch_index_trips_the_guard(bad):
    eng = _engine("ssfl", n_clients=4, local_steps=1, batch_size=4,
                  sanitize=True)
    orig = eng._sample_indices

    def poisoned(ids, steps, batch_size=None):
        out = orig(ids, steps, batch_size)
        out[0, 0, 0] = bad
        return out

    eng._sample_indices = poisoned
    with pytest.raises(SlotSanitizerError, match="out of bounds") as exc:
        eng.run_round()
    assert exc.value.slots == ()
    # the engine survives: the next round, with healthy indices, runs
    eng._sample_indices = orig
    assert np.isfinite(eng.run_round()["loss"])


def test_healthy_small_fleet_does_not_trip():
    eng = _engine("ssfl", n_clients=3, local_steps=1, batch_size=4,
                  sanitize=True)
    assert np.isfinite(eng.run_round()["loss"])


def test_guard_gather_bounds():
    idx = np.array([[0, 9]], np.int32)
    assert guard_gather(idx, 10) is idx
    for bad in (10, -1):
        with pytest.raises(SlotSanitizerError, match=r"\[0, 10\)"):
            guard_gather(np.array([0, bad]), 10)


# ---------------------------------------------------------------- parity

def _assert_same_run(a, b, rounds=2):
    for _ in range(rounds):
        assert a.run_round()["loss"] == b.run_round()["loss"]
    for x, y in zip(tree_leaves(a.state.params), tree_leaves(b.state.params)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.state.local_heads),
                    tree_leaves(b.state.local_heads)):
        assert torch.equal(x, y)


def test_sanitize_false_is_bitwise_the_default_engine():
    _assert_same_run(_engine("ssfl"), _engine("ssfl", sanitize=False))


@pytest.mark.parametrize("method", ["ssfl", "sfl", "fedavg"])
def test_healthy_sanitized_rounds_match_bit_exact(method):
    # availability 0.7 leaves unreachable clients, whose masked paths the
    # check reads too
    _assert_same_run(_engine(method, availability=0.7),
                     _engine(method, availability=0.7, sanitize=True))


@pytest.mark.parametrize("sanitize", [False, True])
def test_only_the_sanitized_engine_enters_a_dispatch_mode(sanitize):
    eng = _engine("ssfl", sanitize=sanitize)
    seen = []
    step = eng.strategy.cohort_step

    def spy(*args):
        seen.append(_get_current_dispatch_mode())
        return step(*args)

    eng.strategy.cohort_step = spy
    eng.run_round()
    assert seen
    if sanitize:
        assert all(isinstance(m, FloatCheck) for m in seen)
    else:
        assert all(m is None for m in seen)


def test_a_failure_inside_a_step_raises_as_itself():
    eng = _engine("ssfl", sanitize=True)

    def fails(*args):
        torch.ones(3) / torch.zeros(3)        # would trip the check
        raise RuntimeError("kernel launch failed")

    eng.strategy.cohort_step = fails
    with pytest.raises(RuntimeError, match="kernel launch failed") as exc:
        eng.run_round()
    assert not isinstance(exc.value, SlotSanitizerError)


# ------------------------------------------------------- the float check

def test_float_check_catches_a_nan_that_a_where_masks_out():
    x = torch.tensor([-1.0, 4.0])
    with FloatCheck() as check:
        y = torch.where(x > 0, torch.sqrt(x), torch.zeros(()))
    assert torch.isfinite(y).all()
    assert "nan generated by aten.sqrt" in check.failure()


@pytest.mark.parametrize("divide", [
    lambda x, z: x / z, lambda x, z: 1.0 / z, lambda x, z: x / 0.0,
    lambda x, z: torch.div(x, z, rounding_mode="floor")],
    ids=["tensor", "reciprocal", "python-zero", "floor"])
def test_float_check_catches_a_division_by_zero(divide):
    x, z = torch.tensor([1.0, 2.0]), torch.tensor([1.0, 0.0])
    with FloatCheck() as check:
        divide(x, z)
    assert "division by zero" in check.failure()


def test_float_check_quiet_on_healthy_ops_views_and_factories():
    nan = torch.full((4,), float("nan"))
    with FloatCheck() as check:
        a = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
        (a @ a.T).softmax(-1).sum().item()
        nan[1:]                                  # a view makes no value
        torch.empty_like(nan), torch.empty(64)   # uninitialised, exempt
    assert check.failure() is None
    with FloatCheck() as check:
        nan[1:] + 0.0
    assert "nan generated by aten.add" in check.failure()


def test_float_check_names_the_first_trip():
    with FloatCheck() as check:
        torch.tensor([1.0]) / torch.tensor([0.0])          # inf, a div
        torch.tensor([-1.0]).log()                          # then a nan
    assert check.failure().startswith("division by zero")


def test_nonfinite_slots_reads_only_cohort_leading_leaves():
    out = {"losses": torch.tensor([0.5, float("nan"), 1.0]),
           "rows": torch.tensor([[1.0, 2.0], [3.0, 4.0], [float("inf"), 0]]),
           "server": torch.full((4, 2), float("nan")),     # not cohort-led
           "ids": torch.tensor([0, 1, 2])}                 # not floating
    assert nonfinite_slots(out, 3) == (1, 2)
    assert nonfinite_slots({"losses": torch.ones(3)}, 3) == ()
