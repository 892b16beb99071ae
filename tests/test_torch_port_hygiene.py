"""What the port may import, and where it may run.

``horovod_tpu_torch`` and ``chip_smoke.py`` import torch and never JAX,
flax, optax or ``horovod_tpu``; entry points run on CUDA unless asked for
the CPU; the kernel wrappers launch CUDA kernels and take no CPU tensor.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several pytest workers at once,
    and torch would otherwise start one thread per core in each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "tools" / "chip_fault_check.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, "%s imports %s" % (path.name, bad)


def test_package_imports_with_jax_blocked():
    """Every module of the package, and chip_smoke, imports in a process
    where importing JAX or horovod_tpu fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in %r: sys.modules[m] = None\n"
        "import horovod_tpu_torch as hvd\n"
        "mods = [m.name for m in pkgutil.walk_packages(hvd.__path__, "
        "'horovod_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(sys.modules.get(m) for m in %r)\n"
        "print(len(mods))\n" % (FORBIDDEN, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip()) >= 25


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import init_params, params_from_jax
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.models import convert_resnet
    from horovod_tpu_torch.models.resnet import ResNet, ResNetConfig
    from horovod_tpu_torch.models import convert_bert
    from horovod_tpu_torch.models.bert import Bert, BertConfig
    from horovod_tpu_torch.train import (make_bert_train_step,
                                         make_resnet_train_step,
                                         make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=16, d_model=64, n_layers=1,
                            n_heads=2, n_kv_heads=2, d_ff=32, max_seq=8)
    rcfg = ResNetConfig(depth=18, num_classes=4, dtype="float32")
    adam = lambda ps: torch.optim.Adam(ps)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9)
    variables = convert_resnet.init_params(18, 4)
    bcfg = BertConfig(vocab_size=16, d_model=32, n_layers=1, n_heads=2,
                      d_ff=32, max_seq=8)
    adamw = lambda ps: torch.optim.AdamW(ps)
    for call in (hvd.init, lambda: Transformer(cfg),
                 lambda: params_from_jax(init_params(cfg), cfg),
                 lambda: make_train_step(cfg, adam),
                 lambda: ResNet(rcfg),
                 lambda: convert_resnet.params_from_flax(variables, rcfg),
                 lambda: make_resnet_train_step(rcfg, sgd),
                 lambda: Bert(bcfg),
                 lambda: convert_bert.params_from_jax(
                     convert_bert.init_params(bcfg), bcfg),
                 lambda: make_bert_train_step(bcfg, adamw),
                 lambda: make_bert_train_step(bcfg, adamw, op=hvd.Adasum)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not hvd.is_initialized()
    model = params_from_jax(init_params(cfg), cfg, device="cpu")
    assert model.embed.device.type == "cpu"
    make_train_step(cfg, adam, device="cpu")
    resnet = convert_resnet.params_from_flax(variables, rcfg, device="cpu")
    assert resnet.stem.weight.device.type == "cpu"
    make_resnet_train_step(rcfg, sgd, device="cpu")
    bert = convert_bert.params_from_jax(convert_bert.init_params(bcfg), bcfg,
                                        device="cpu")
    assert bert.word_embed.device.type == "cpu"
    make_bert_train_step(bcfg, adamw, device="cpu")


def test_kernel_wrappers_take_no_cpu_tensor():
    from horovod_tpu_torch.ops import flash_attention as fa
    fa.reset_launch_counts()
    x = torch.zeros(2, 64, 32, dtype=torch.bfloat16)
    rows = torch.zeros(2, 64)
    calls = (lambda: fa.flash_fwd_kernel(x, x, x, True),
             lambda: fa.flash_bwd_dq_kernel(x, x, x, x, rows, rows, True),
             lambda: fa.flash_bwd_dkv_kernel(x, x, x, x, rows, rows, True),
             lambda: fa.flash_bwd_onepass_kernel(x, x, x, x, rows, rows, True))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA kernel"):
            call()
    assert fa.launch_counts() == {k.__name__: 0 for k in fa.KERNELS}
    # The dispatchers take the plain versions for CPU tensors only.
    o, lse = fa.flash_fwd(x, x, x, True)
    ref_o, ref_lse = fa.flash_fwd_reference(x, x, x, True)
    np.testing.assert_array_equal(o.float().numpy(), ref_o.float().numpy())
    assert fa.launch_counts() == {k.__name__: 0 for k in fa.KERNELS}


def test_bn_kernel_wrappers_take_no_cpu_tensor():
    from horovod_tpu_torch.ops import batch_norm as bn
    bn.reset_launch_counts()
    x = torch.zeros(64, 8, dtype=torch.bfloat16)
    v = torch.ones(8)
    calls = (lambda: bn.bn_stats_kernel(x),
             lambda: bn.bn_apply_kernel(x, v, v, v, v, x, 1e-5, True),
             lambda: bn.bn_bwd_reductions_kernel(x, x, v, v, v, v, None,
                                                 1e-5, True),
             lambda: bn.bn_bwd_dx_kernel(x, x, v, v, v, v, v, v, x, 1e-5,
                                         False))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA kernel"):
            call()
    assert bn.launch_counts() == {k.__name__: 0 for k in bn.KERNELS}
    # The dispatchers take the plain versions for CPU tensors only, and
    # the autograd function runs them without counting a launch.
    xs = torch.randn(2, 8, 4, 4).to(memory_format=torch.channels_last)
    y, mean, var = bn.batch_norm_act(xs.requires_grad_(), v, 0 * v)
    y.backward(torch.randn_like(y))
    assert xs.grad.is_contiguous(memory_format=torch.channels_last)
    s, q = bn.bn_stats(x)
    np.testing.assert_array_equal(s.numpy(), bn.bn_stats_reference(x)[0])
    assert bn.launch_counts() == {k.__name__: 0 for k in bn.KERNELS}


def test_adasum_on_cpu_tensors_launches_no_kernel():
    """Adasum's combine takes the scale-sum kernel's plain version for CPU
    tensors, and its wrapper takes no CPU tensor."""
    from horovod_tpu_torch.ops import scale_sum as ss
    from horovod_tpu_torch.utils.adasum import adasum_reduce_stacked
    ss.reset_launch_counts()
    x = torch.arange(12, dtype=torch.float32).view(4, 3)
    out = adasum_reduce_stacked(x)
    assert out.shape == (3,) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="CUDA kernel"):
        ss.scale_sum_kernel(x, x)
    assert ss.launch_counts() == {"scale_sum_kernel": 0}


def test_kernels_build_into_an_ignored_directory():
    """The kernels build under the package at first use, into a
    ``build/`` directory that ``.gitignore`` lists, from the sources in
    ``csrc/``."""
    from horovod_tpu_torch.ops import _build
    rel = _build.build_dir().relative_to(REPO)
    assert rel.parts[:2] == ("horovod_tpu_torch", "build")
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert {s.name for s in _build.sources()} == {"flash_fwd.cu",
                                                  "flash_fwd_f32.cu",
                                                  "flash_bwd_f32.cu",
                                                  "flash_bwd.cu",
                                                  "flash_bwd_onepass.cu",
                                                  "flash_simt.cu",
                                                  "batch_norm.cu",
                                                  "scale_sum.cu"}


def test_capability_probes_tell_the_truth():
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert hvd.nccl_built() == dist.is_nccl_available()
    assert hvd.gloo_built() == dist.is_gloo_available()
    assert hvd.mpi_built() == dist.is_mpi_available()
