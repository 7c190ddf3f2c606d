"""Importing and running the port's scheduler loads neither jax nor any
``ray_tpu`` module (checked in a fresh interpreter)."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_scheduler_imports_no_jax_or_ray_tpu():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import ray_tpu_torch.scheduler as S\n"
        "import ray_tpu_torch.scheduler.unpark, ray_tpu_torch.scheduler.labels\n"
        "import ray_tpu_torch.scheduler.instances, ray_tpu_torch.scheduler.serve_demand\n"
        "import ray_tpu_torch.config, ray_tpu_torch.util.tracing, ray_tpu_torch._ids\n"
        "vocab = S.ResourceVocab(); view = S.ClusterView(vocab)\n"
        "[view.add_node(f'n{i}', {'CPU': 4.0}) for i in range(3)]\n"
        "st = S.DeviceSchedulerState(platform='cpu'); st.sync(view)\n"
        "d = np.zeros(view.totals.shape[1], np.float32); d[0] = 1.0\n"
        "assert (st.schedule(np.stack([d] * 5)) >= 0).all()\n"
        "S.schedule_bundles(*view.active_arrays(), np.stack([d, d]), 'PACK', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ray_tpu' or m.startswith('ray_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout
