"""The pieces the GPU bring-up added: the pytree base, the stdlib PNG
codec, the compile-cache helper, and chip_smoke.py's refusal to report
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_tpu import runtime
from rt_tpu.io.png_io import decode_png, encode_png, load_image
from rt_tpu.pytree import PyTreeNode, static_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Node(PyTreeNode):
    x: jnp.ndarray
    y: jnp.ndarray | None = None
    size: int = static_field(3)


def test_pytree_replace_and_leaves():
    node = _Node(x=jnp.ones(2), size=5)
    assert jax.tree.leaves(node) == [node.x]  # None child, static field excluded
    other = node.replace(y=jnp.zeros(1))
    assert other.size == 5 and node.y is None and len(jax.tree.leaves(other)) == 2
    doubled = jax.tree.map(lambda a: a * 2, other)
    assert isinstance(doubled, _Node) and doubled.size == 5
    with pytest.raises(AttributeError):
        node.x = jnp.zeros(2)  # frozen


def test_pytree_static_field_in_jit_cache_key():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.size)
        return node.x * node.size

    np.testing.assert_array_equal(f(_Node(x=jnp.ones(2), size=2)), [2.0, 2.0])
    f(_Node(x=jnp.zeros(2), size=2))  # same static value: cached
    np.testing.assert_array_equal(f(_Node(x=jnp.ones(2), size=4)), [4.0, 4.0])
    assert traces == [2, 4]


def test_png_round_trip(tmp_path, rng):
    rgb = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(rgb)), rgb)
    path = tmp_path / "img.png"
    path.write_bytes(encode_png(rgb))
    np.testing.assert_allclose(load_image(str(path)), rgb / 255.0, atol=1e-7)


def test_png_decodes_committed_golden():
    """A golden written by another encoder (its scanlines use every filter
    type the encoder chose) decodes to an image of the expected shape."""
    with open(os.path.join(REPO, "tests", "goldens", "cover.png"), "rb") as f:
        data = f.read()
    img = decode_png(data)
    assert img.shape == (54, 96, 3) and img.dtype == np.uint8
    assert 0 < img.mean() < 255
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == runtime.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == runtime.CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(runtime.CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(runtime.CACHE_DIR) + "/" in f.read().split()


def test_chip_smoke_device_phase_refuses_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.phase_device("unused")


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """Alone in a directory, the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
