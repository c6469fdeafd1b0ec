from wiflow_tpu_torch.parallel.mesh import (
    global_sums, local_rows, pad_to_multiple, rank, spawn, world_size,
)
