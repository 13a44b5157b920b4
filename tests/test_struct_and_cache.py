"""The pytree dataclass helper (tpu_rt/core/struct.py), the compile-cache
helper (tpu_rt/utils/compile_cache.py) and the Perfetto trace reduction
(tpu_rt/utils/profiling.py)."""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_rt.core import struct
from tpu_rt.utils import compile_cache
from tpu_rt.utils.profiling import device_busy_us

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _Rec:
    x: jnp.ndarray
    y: jnp.ndarray
    n: int = struct.field(pytree_node=False, default=3)


def test_struct_replace_and_frozen():
    r = _Rec(jnp.ones(2), jnp.zeros(2))
    r2 = r.replace(n=5, x=jnp.full(2, 7.0))
    assert r.n == 3 and r2.n == 5
    np.testing.assert_array_equal(np.asarray(r2.x), [7.0, 7.0])
    np.testing.assert_array_equal(np.asarray(r2.y), np.asarray(r.y))
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.x = jnp.zeros(2)


def test_struct_flatten_unflatten_keeps_meta_in_treedef():
    r = _Rec(jnp.arange(3.0), jnp.ones(1), n=9)
    leaves, treedef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2  # meta field n is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, [2 * v for v in leaves])
    assert isinstance(back, _Rec) and back.n == 9
    np.testing.assert_array_equal(np.asarray(back.x), [0.0, 2.0, 4.0])
    # different meta values are different tree structures
    assert treedef != jax.tree_util.tree_structure(r.replace(n=1))


def test_struct_meta_fields_are_static_under_jit():
    traces = []

    @jax.jit
    def f(r):
        traces.append(r.n)
        assert isinstance(r.n, int)  # not traced
        return r.x * r.n + r.y

    r = _Rec(jnp.ones(2), jnp.ones(2), n=2)
    np.testing.assert_array_equal(np.asarray(f(r)), [3.0, 3.0])
    f(r.replace(x=jnp.zeros(2)))  # same structure: no retrace
    np.testing.assert_array_equal(np.asarray(f(r.replace(n=4))), [5.0, 5.0])
    assert traces == [2, 4]
    g = jax.grad(lambda r: jnp.sum(f(r)))(r)
    np.testing.assert_array_equal(np.asarray(g.x), [2.0, 2.0])


def test_compile_cache_default_dir_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_env_var_wins_and_cache_lands_there(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, a fresh process compiles into
    that directory and nothing else is set."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from tpu_rt.utils.compile_cache import enable_compile_cache\n"
        "p = enable_compile_cache(min_compile_time_secs=0)\n"
        "assert jax.config.jax_compilation_cache_dir == p, p\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7)).block_until_ready()\n"
        "print(p)\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)
    assert any(tmp_path.iterdir()), "no compiled program written to the cache"


def _trace(events, processes):
    meta = [{"ph": "M", "pid": pid, "name": "process_name",
             "args": {"name": name}} for pid, name in processes.items()]
    return {"traceEvents": meta + events}


def test_device_busy_is_union_of_gpu_track_events(tmp_path):
    ev = [
        # GPU 0: two tracks repeating one span + a nested op -> 10..40, 50..60
        {"ph": "X", "pid": 1, "tid": 1, "ts": 10.0, "dur": 30.0, "name": "m"},
        {"ph": "X", "pid": 1, "tid": 2, "ts": 12.0, "dur": 5.0, "name": "op"},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 50.0, "dur": 10.0, "name": "m"},
        # host thread: ignored
        {"ph": "X", "pid": 9, "tid": 1, "ts": 0.0, "dur": 1000.0, "name": "py"},
        # GPU 1
        {"ph": "X", "pid": 2, "tid": 1, "ts": 0.0, "dur": 7.0, "name": "m"},
    ]
    tr = _trace(ev, {1: "/device:GPU:0", 2: "/device:GPU:1", 9: "/host:CPU"})
    f = tmp_path / "perfetto_trace.json.gz"
    with gzip.open(f, "wt") as fh:
        json.dump(tr, fh)
    with gzip.open(f, "rt") as fh:
        busy = device_busy_us(json.load(fh))
    assert busy == {"/device:GPU:0": 40.0, "/device:GPU:1": 7.0}


def test_device_busy_raises_without_gpu_track():
    tr = _trace([{"ph": "X", "pid": 9, "ts": 0.0, "dur": 5.0, "name": "py"}],
                {9: "/host:CPU"})
    with pytest.raises(RuntimeError, match="no GPU device track"):
        device_busy_us(tr)
