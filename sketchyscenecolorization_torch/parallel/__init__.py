from .mesh import (create_mesh, current_mesh, data_index, data_size,
                   is_first_rank, local_batch_size, rank_device,
                   reduce_gradients, reduce_metrics, replicate, set_mesh,
                   shard_batch)
from .prefetch import (BackgroundGenerator, mesh_batches, prefetch_to_device,
                       to_device)
