"""Multi-device rendering over ``torch.distributed`` (``art_tpu.parallel``)."""

from art_tpu_torch.parallel.sharding import (
    make_mesh,
    render_scene_sharded,
    sharded_render_step,
    spawn_ranks,
)

__all__ = ["make_mesh", "render_scene_sharded", "sharded_render_step", "spawn_ranks"]
