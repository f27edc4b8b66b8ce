"""The port's compute ops (`ray_tpu.ops`'s names): attention and RoPE in
plain PyTorch, ring attention over a mesh axis, and the losses.

`flash_attention` is not re-exported here: its name would hide the module
`ray_tpu_torch.ops.flash_attention`, which holds the kernels' launch
counters; import it from that module."""

from ray_tpu_torch.ops.attention import apply_rope, decode_attention, mha_reference, rope_table
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.ops import losses

__all__ = ["apply_rope", "decode_attention", "mha_reference", "rope_table", "ring_attention",
           "losses"]
