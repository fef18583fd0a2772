from tpualign_torch.models.clip import CLIP, build_clip, init_clip_params
from tpualign_torch.models.convert import from_jax_params
from tpualign_torch.models.loader import (
    convert_hf_clip_state_dict, convert_openclip_state_dict, load_checkpoint_params)

__all__ = ["CLIP", "build_clip", "init_clip_params", "from_jax_params", "load_checkpoint_params",
           "convert_openclip_state_dict", "convert_hf_clip_state_dict"]
