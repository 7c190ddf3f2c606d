"""ray_tpu_torch.ops.layers against ray_tpu.ops.layers on the CPU, and the
port's package boundary (no jax, no ray_tpu)."""
import ast
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import layers as J
from ray_tpu_torch.ops import layers as T

REPO = pathlib.Path(__file__).resolve().parents[1]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bf16(a: np.ndarray):
    """The same bf16 values in both frameworks."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def test_rms_norm_f32():
    x, w = _rand(0, 3, 5, 64), _rand(1, 64)
    np.testing.assert_allclose(
        np.asarray(J.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        T.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        rtol=1e-6, atol=1e-6,
    )


def test_rms_norm_bf16_rounds_before_the_weight():
    # normalise in f32, cast to bf16, then multiply by the bf16 weight
    xj, xt = _bf16(_rand(2, 4, 128))
    wj, wt = _bf16(_rand(3, 128))
    want = np.asarray(J.rms_norm(xj, wj).astype(jnp.float32))
    got = T.rms_norm(xt, wt).float().numpy()
    assert T.rms_norm(xt, wt).dtype == torch.bfloat16
    # one bf16 ulp (2**-8 relative) where an f32 rsqrt ulp flips a rounding
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("head_dim,max_len", [(16, 32), (64, 128)])
def test_rope_freqs(head_dim, max_len):
    np.testing.assert_allclose(
        np.asarray(J.rope_freqs(head_dim, max_len)),
        T.rope_freqs(head_dim, max_len).numpy(), rtol=1e-6, atol=1e-6,
    )


def test_apply_rope():
    x = _rand(4, 2, 12, 3, 16)
    ang_j = J.rope_freqs(16, 12)
    want = np.asarray(J.apply_rope(jnp.asarray(x), ang_j))
    got = T.apply_rope(torch.from_numpy(x), T.rope_freqs(16, 12)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_swiglu():
    x, wg, wu, wd = _rand(5, 6, 32), _rand(6, 32, 48), _rand(7, 32, 48), _rand(8, 48, 32)
    want = np.asarray(J.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = T.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "causal,q_offset,h,hkv", [(True, 0, 4, 4), (False, 0, 4, 2), (True, 5, 8, 2)]
)
def test_attention_reference(causal, q_offset, h, hkv):
    q, k, v = _rand(9, 2, 7, h, 16), _rand(10, 2, 12, hkv, 16), _rand(11, 2, 12, hkv, 16)
    want = np.asarray(J.attention_reference(
        *map(jnp.asarray, (q, k, v)), causal=causal, q_offset=q_offset))
    got = T.attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, q_offset=q_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_attention_reference_bf16():
    # scores in bf16, softmax in f32, probabilities back in bf16
    (qj, qt), (kj, kt), (vj, vt) = (_bf16(_rand(s, 1, 9, 4, 32)) for s in (12, 13, 14))
    want = np.asarray(J.attention_reference(qj, kj, vj).astype(jnp.float32))
    got = T.attention_reference(qt, kt, vt).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_import_pulls_in_neither_jax_nor_ray_tpu(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SCHED_PLATFORM", "cpu")
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch._cuda, ray_tpu_torch._jaxrng\n"
        "import ray_tpu_torch.ops.layers, ray_tpu_torch.ops.flash_attention\n"
        "import ray_tpu_torch.ops.paged_attention, ray_tpu_torch.models.transformer\n"
        "import ray_tpu_torch.llm.engine, ray_tpu_torch.llm.continuous\n"
        "import ray_tpu_torch.cluster.head, ray_tpu_torch.cluster.agent\n"
        "import ray_tpu_torch.cluster.worker, ray_tpu_torch.cluster.client\n"
        "import ray_tpu_torch.autoscaler, ray_tpu_torch.scheduler.sim\n"
        "import ray_tpu_torch.cluster.standby, ray_tpu_torch.autoscaler.gce\n"
        "import ray_tpu_torch.dag, ray_tpu_torch.rdt, ray_tpu_torch.experimental\n"
        "import ray_tpu_torch.util.state, ray_tpu_torch.cluster.dashboard\n"
        "import ray_tpu_torch.llm, ray_tpu_torch.serve.prefix_cache\n"
        "import ray_tpu_torch.serve.admission, ray_tpu_torch.models.moe\n"
        "import ray_tpu_torch.llm.processor\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.dryrun\n"
        "import ray_tpu_torch.parallel.programs, ray_tpu_torch.ops.pipeline\n"
        "import ray_tpu_torch.ops.ring_attention, ray_tpu_torch.ops.ulysses\n"
        "import ray_tpu_torch.train, ray_tpu_torch.train.programs, ray_tpu_torch.tune\n"
        "import torch\n"
        "from ray_tpu_torch.ops.flash_attention import flash_attention\n"
        "from ray_tpu_torch.models import transformer as tfm\n"
        "q = torch.randn(1, 70, 2, 32, requires_grad=True)\n"
        "flash_attention(q, q.detach(), q.detach()).sum().backward()\n"
        "cfg = tfm.ModelConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2,\n"
        "                      n_kv_heads=1, d_ff=64, dtype=torch.float32, remat=True)\n"
        "p = tfm.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "opt = torch.optim.AdamW([x.requires_grad_() for x in tfm.param_leaves(p)])\n"
        "tfm.make_train_step(cfg, opt)(p, torch.randint(0, 32, (1, 9)))\n"
        "from ray_tpu_torch.parallel import local_mesh\n"
        "tfm.make_train_step(cfg, opt, local_mesh('cpu'))(p, torch.randint(0, 32, (1, 9)))\n"
        "from ray_tpu_torch.llm import LLMEngine, GenerationConfig\n"
        "moe = tfm.ModelConfig(vocab_size=32, d_model=32, n_layers=1, n_heads=2,\n"
        "                      n_kv_heads=1, d_ff=64, n_experts=2, dtype=torch.float32)\n"
        "LLMEngine(moe, max_len=16, device='cpu').generate_ids([[1, 2]], GenerationConfig(4))\n"
        "rt = ray_tpu_torch.init(num_nodes=1, resources_per_node={'CPU': 2})\n"
        "assert rt.device_state.device.type == 'cpu'\n"
        "f = ray_tpu_torch.remote(lambda x: x + 1)\n"
        "assert ray_tpu_torch.get(f.remote(1), timeout=60) == 2\n"
        "ray_tpu_torch.shutdown()\n"
        "from ray_tpu_torch.cluster.serialization import dumps_parts, join_parts, loads\n"
        "t = torch.arange(6.0)\n"
        "assert torch.equal(loads(memoryview(join_parts(dumps_parts(t)[0]))), t)\n"
        "import tempfile, os\n"
        "from ray_tpu_torch.train import Checkpoint\n"
        "d = os.path.join(tempfile.mkdtemp(), 'c')\n"
        "w = torch.arange(6.0).to(torch.bfloat16)\n"
        "back = Checkpoint.from_state({'p': {'w': w}, 'opt': opt.state_dict()}, d).load_state()\n"
        "assert torch.equal(back['p']['w'], w)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == "", out.stdout


def test_no_source_of_the_port_imports_jax_or_ray_tpu():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "ray_tpu"), f"{path}: imports {name}"
