"""quest_tpu_torch's measurement streams against quest_tpu's, on the CPU.

* ``ops/threefry.py`` against ``jax.random`` bit for bit: the key that
  seedQuEST makes from 1 to 3 seeds (seed 0 and seeds >= 2^31 among
  them), and ``jax.random.uniform(jax.random.fold_in(key, shot),
  dtype)`` at float32 and float64 over 200 shots a seed list (shot 0,
  consecutive shots, and shots up to 2^32 - 1): 2400 (seed list, shot)
  pairs at each dtype.  A JAX upgrade that changes the stream (its
  ``jax_threefry_partitionable`` default, say) fails here instead of
  drifting silently.
* The constants the chip check copies: seeds [1234, 5678], shots 0-2.
* The host Mersenne Twister (rng.GLOBAL_RNG) and the key state
  (measurement.KEYS): seedQuEST gives the reference's snapshots as equal
  JSON; ``interop.rng_state_from_reference`` continues both streams.
* The seeding repair: createQuESTEnv's time+pid default seed is logged
  on stderr and shown as ``DefaultSeed=``; seedQuEST clears it.

Every comparison is exact: the streams are integer arithmetic.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import quest_tpu as qt
import quest_tpu_torch as tq
from quest_tpu import rng as ref_rng
from quest_tpu.ops import measurement as ref_measurement
from quest_tpu_torch import interop, rng
from quest_tpu_torch.ops import measurement, threefry

SEED_LISTS = [
    [0],
    [1],
    [1234],
    [2 ** 31],
    [2 ** 32 - 1],
    [1234, 5678],
    [0, 2 ** 31 + 5],
    [3, 1, 4],
    [2 ** 31 + 1, 0, 2 ** 32 - 2],
    [7, 2 ** 31 - 1],
    [99, 5, 2 ** 31 + 7],
    [42],
]

# shots 0..99, 100 scattered shots up to 2^32 - 1
SHOTS = np.concatenate([
    np.arange(100, dtype=np.uint64),
    np.random.default_rng(3).integers(100, 2 ** 32, 99, dtype=np.uint64),
    np.array([2 ** 32 - 1], dtype=np.uint64),
])

# jax.random.uniform(fold_in(PRNGKey(1234) folded with 5678, shot)) for
# shots 0, 1, 2 (copied into chip_smoke.py's measure_parity phase)
PINNED_F32 = [0.13736069, 0.18848944, 0.5674375]
PINNED_F64 = [0.49697267, 0.1997721, 0.90429892]


@pytest.fixture(autouse=True)
def _keep_reference_streams():
    """Both packages' global streams as they were before the test."""
    saved = (ref_rng.GLOBAL_RNG.get_state(),
             ref_measurement.KEYS.get_state(), rng.GLOBAL_RNG.get_state(),
             measurement.KEYS.get_state())
    yield
    ref_rng.GLOBAL_RNG.set_state(saved[0])
    ref_measurement.KEYS.set_state(saved[1])
    rng.GLOBAL_RNG.set_state(saved[2])
    measurement.KEYS.set_state(saved[3])


def _reference_key(seeds):
    ref_measurement.KEYS.seed(seeds)
    return [int(x) for x in np.asarray(ref_measurement.KEYS.key).ravel()]


@pytest.mark.parametrize("seeds", SEED_LISTS, ids=str)
def test_key_from_seeds_is_the_reference_key(seeds):
    assert list(threefry.key_from_seeds(seeds)) == _reference_key(seeds)


_JAX_UNIFORMS = {
    dt: jax.jit(jax.vmap(
        lambda key, shot, dt=dt: jax.random.uniform(
            jax.random.fold_in(key, shot), dtype=dt), in_axes=(None, 0)))
    for dt in (jnp.float32, jnp.float64)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seeds", SEED_LISTS, ids=str)
def test_uniforms_equal_jax_random_bit_for_bit(seeds, dtype):
    key = threefry.key_from_seeds(seeds)
    jkey = jnp.asarray(np.array(key, dtype=np.uint32))
    want = np.asarray(_JAX_UNIFORMS[jnp.dtype(dtype).type](
        jkey, jnp.asarray(SHOTS.astype(np.uint32))))
    # the port draws runs of consecutive shots: one call per shot here
    got = np.concatenate([threefry.uniforms(key, int(s), 1, dtype)
                          for s in SHOTS])
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert np.array_equal(got, want)
    run = threefry.uniforms(key, 0, 100, dtype)
    assert np.array_equal(run, got[:100])


def test_pinned_values_of_the_chip_check():
    key = threefry.key_from_seeds([1234, 5678])
    assert key == (4049511045, 3108253641)
    f32 = threefry.uniforms(key, 0, 3, "float32")
    f64 = threefry.uniforms(key, 0, 3, "float64")
    assert np.array_equal(f32, np.array(PINNED_F32, dtype=np.float32))
    assert np.allclose(f64, PINNED_F64, rtol=0, atol=1e-8)
    jkey = jnp.asarray(np.array(key, dtype=np.uint32))
    assert np.array_equal(
        f64, np.asarray(_JAX_UNIFORMS[jnp.float64](
            jkey, jnp.arange(3, dtype=jnp.uint32))))


def test_threefry_block_is_the_published_known_answer():
    """Threefry-2x32, 20 rounds: the Random123 known-answer vector for
    key = counter = (0, 0) (kat_vectors, threefry2x32_20)."""
    x0, x1 = threefry.threefry2x32(0, 0, 0, 0)
    assert (int(x0[0]), int(x1[0])) == (0x6b200159, 0x99ba4efe)


@pytest.mark.parametrize("seeds", [[1234, 5678], [0], [2 ** 31 + 3, 9]],
                         ids=str)
def test_seed_quest_gives_the_reference_snapshots(seeds):
    ref_env = qt.createQuESTEnv(num_devices=1)
    env = tq.createQuESTEnv(device="cpu")
    qt.seedQuEST(ref_env, seeds)
    tq.seedQuEST(env, seeds)
    assert env.seeds == ref_env.seeds
    for _ in range(5):
        assert rng.GLOBAL_RNG.uniform() == ref_rng.GLOBAL_RNG.uniform()
    ref_measurement.KEYS.next_shots(7)
    measurement.KEYS.next_shots(7)
    got = (rng.GLOBAL_RNG.get_state(), measurement.KEYS.get_state())
    want = (ref_rng.GLOBAL_RNG.get_state(), ref_measurement.KEYS.get_state())
    assert json.dumps(got) == json.dumps(want)


def test_rng_state_from_reference_continues_both_streams():
    ref_env = qt.createQuESTEnv(num_devices=1)
    qt.seedQuEST(ref_env, [11, 22])
    for _ in range(3):
        ref_rng.GLOBAL_RNG.uniform()
    ref_measurement.KEYS.next_shots(5)
    interop.rng_state_from_reference(
        json.loads(json.dumps(ref_rng.GLOBAL_RNG.get_state())),
        json.loads(json.dumps(ref_measurement.KEYS.get_state())))
    assert [rng.GLOBAL_RNG.uniform() for _ in range(4)] == \
        [ref_rng.GLOBAL_RNG.uniform() for _ in range(4)]
    key, shot = measurement.KEYS.next_shots(3)
    rkey, rshot = ref_measurement.KEYS.next_shots(3)
    assert shot == rshot == 5
    assert list(key) == [int(x) for x in np.asarray(rkey).ravel()]
    # and the port's own snapshot round-trips
    snap = measurement.KEYS.get_state()
    measurement.KEYS.seed([1])
    measurement.KEYS.set_state(snap)
    assert measurement.KEYS.get_state() == snap


def test_default_seed_is_logged_and_shown(capsys):
    env = tq.createQuESTEnv(device="cpu")
    line = capsys.readouterr().err.strip().splitlines()[-1]
    event = json.loads(line)
    assert event["event"] == "quest_tpu_torch.rng.default_seed"
    assert tuple(event["seeds"]) == env.seeds
    assert rng.GLOBAL_RNG.default_seeded
    assert ("DefaultSeed=" + ",".join(str(s) for s in env.seeds)
            in tq.getEnvironmentString(env))
    assert measurement.KEYS.get_state() == {
        "key": list(threefry.key_from_seeds(env.seeds)), "counter": 0}
    tq.seedQuEST(env, [5])
    assert not rng.GLOBAL_RNG.default_seeded
    assert "DefaultSeed=" not in tq.getEnvironmentString(env)


def test_env_keeps_no_torch_generator():
    env = tq.createQuESTEnv(device="cpu")
    assert not hasattr(env, "generator")


@pytest.mark.parametrize("route", ["fused", "host"])
def test_default_seeded_streams_replay_from_the_logged_keys(route,
                                                            monkeypatch):
    """A default-seeded run replays with seedQuEST(env, <logged keys>)."""
    if route == "host":
        monkeypatch.setenv("QT_HOST_MEASURE", "1")
    env = tq.createQuESTEnv(device="cpu")
    logged = list(env.seeds)

    def run():
        q = tq.createQureg(6, env)
        tq.initPlusState(q)
        return tq.measureSequence(q, range(6))

    first = run()
    tq.seedQuEST(env, logged)
    assert run() == first
