from art_tpu_torch.models.scenes import SCENES, build_scene, scene_defaults

__all__ = ["SCENES", "build_scene", "scene_defaults"]
