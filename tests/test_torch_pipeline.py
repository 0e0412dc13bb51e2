"""The port's GPipe (``repro_torch/distribution/pipeline.py``) against the
reference's bubble fraction, and against the sequential stack: over four
gloo processes on the CPU (a subprocess with a timeout, the ranks joined
through a ``FileStore``: no TCP port), and on a world of one."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SCRIPT = r"""
import os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def rank_main(rank, path):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distribution import PipelineConfig, gpipe
    dist.init_process_group("gloo", store=dist.FileStore(path, 4),
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 16, 16, generator=gen) * 0.3
    x = torch.randn(8, 16, generator=gen)
    pipe = gpipe(lambda p, h: torch.tanh(h @ p), mesh,
                 PipelineConfig(axis="pod", microbatches=4))
    # rank r passes its own stage's (1, ...) slice
    y = pipe(w[rank:rank + 1], x)
    ref = x
    for i in range(4):
        ref = torch.tanh(ref @ w[i])
    err = float((y - ref).abs().max())
    assert err < 1e-6, (rank, err)
    dist.destroy_process_group()
    print("PIPE_OK", rank, err, flush=True)

if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1],), nprocs=4, join=True)
"""


def test_gpipe_matches_sequential_over_four_gloo_ranks(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    script = tmp_path / "pipe.py"
    script.write_text(SCRIPT)
    out = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.count("PIPE_OK") == 4, out.stderr[-2000:]


def test_gpipe_world_of_one_equals_the_stack():
    """One process, one stage: the stage over every micro-batch equals
    the stack run straight, bit for bit; the whole (S, ...) stack passed,
    rank 0 takes its own row."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distribution import PipelineConfig, gpipe

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        gen = torch.Generator().manual_seed(1)
        w = torch.randn(1, 16, 16, generator=gen) * 0.3
        x = torch.randn(12, 16, generator=gen)
        pipe = gpipe(lambda p, h: torch.tanh(h @ p), mesh,
                     PipelineConfig(microbatches=4))
        y = pipe(w, x)
        ref = torch.cat([torch.tanh(c @ w[0]) for c in x.split(3)])
        assert torch.equal(y, ref)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("m,s", [(4, 2), (8, 2), (4, 4), (16, 3), (1, 1)])
def test_bubble_fraction_equals_the_reference(m, s):
    from repro.distribution import PipelineConfig as RefConfig

    from repro_torch.distribution import PipelineConfig

    assert PipelineConfig(microbatches=m).bubble_fraction(s) == \
        RefConfig(microbatches=m).bubble_fraction(s)
