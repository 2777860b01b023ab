"""Device mesh and multi-slice helpers (mirrors ``traceweaver_tpu/parallel``).

- :mod:`~traceweaver_tpu_torch.parallel.mesh`: the window axis sharded
  over a mesh of devices held in this process;
- :mod:`~traceweaver_tpu_torch.parallel.multislice`: corpus-level data
  parallelism across processes, with the edge statistics reduced through
  ``torch.distributed`` or the filesystem.
"""

from traceweaver_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    em_step_sharded,
    make_mesh,
    shard_solve_windows,
)
