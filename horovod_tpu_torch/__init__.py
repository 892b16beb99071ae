"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The synchronous data-parallel training step over ``torch.distributed``
(NCCL on CUDA, gloo on the CPU) and Horovod's collective surface
(allreduce with Adasum, allgather, reducescatter, alltoall, broadcast,
barrier, join, process sets) behind a negotiating engine: named requests
are negotiated across ranks by rank 0, fused by threshold and executed
in one order on every rank by one cycle thread; once a round of
allreduces repeats on every rank, its schedule freezes and goes out in
overlap buckets without negotiation (the fast path).  The attention,
BatchNorm and Adasum-combine kernels are written by hand in CUDA C++ for
Hopper (``csrc/``).  Usage mirrors Horovod's::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(), 1e-3))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    loss.backward(); opt.step()

Entry points run on CUDA unless the caller passes ``device="cpu"``.
The package imports ``torch`` and never ``jax`` or ``horovod_tpu``;
the top-level namespace resolves lazily (PEP 562).
"""

__version__ = "0.1.0"

# name -> (module, attr)
_EXPORTS = {}
for _mod, _names in (
    (".common.basics",
     ("init", "shutdown", "is_initialized", "rank", "size", "local_rank",
      "local_size", "cross_rank", "cross_size", "is_homogeneous",
      "topology", "device", "nccl_built", "gloo_built", "mpi_built",
      "cuda_built")),
    (".common.process_sets",
     ("ProcessSet", "global_process_set", "add_process_set",
      "remove_process_set", "process_set_by_id", "process_set_ids")),
    (".common.metrics", ("metrics_snapshot",)),
    (".common.resilience", ("check_degraded_routes",)),
    (".ops.engine", ("CollectiveDeadlineExceeded",)),
    (".ops.api",
     ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT", "ADASUM", "Handle",
      "allreduce", "allreduce_async", "grouped_allreduce",
      "grouped_allreduce_async", "allgather", "allgather_async",
      "grouped_allgather", "grouped_allgather_async", "reducescatter",
      "reducescatter_async", "grouped_reducescatter",
      "grouped_reducescatter_async", "alltoall", "alltoall_async",
      "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
      "barrier", "join", "synchronize", "poll", "HorovodInternalError")),
    (".optimizer", ("DistributedOptimizer", "allreduce_gradients")),
    (".data_parallel", ("shard_batch", "metric_average")),
    (".callbacks",
     ("Callback", "BroadcastGlobalVariablesCallback",
      "MetricAverageCallback", "LearningRateWarmupCallback",
      "LearningRateScheduleCallback")),
    (".compression", ("Compression",)),
    (".functions",
     ("broadcast_parameters", "broadcast_optimizer_state",
      "broadcast_object", "allgather_object")),
):
    for _n in _names:
        _EXPORTS[_n] = (_mod, _n)

# Horovod spells the reduce ops hvd.Sum, hvd.Average, ...
for _alias, _target in (("Sum", "SUM"), ("Average", "AVERAGE"),
                        ("Min", "MIN"), ("Max", "MAX"),
                        ("Product", "PRODUCT"), ("Adasum", "ADASUM")):
    _EXPORTS[_alias] = (".ops.api", _target)

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            "module %r has no attribute %r" % (__name__, name)) from None
    import importlib
    value = getattr(importlib.import_module(mod_name, __name__), attr)
    globals()[name] = value
    return value


def __dir__():
    return __all__
