"""Device-side 'JPEG decode' kernels (counter-hash pixel synthesis).

``repro_torch.data.synthetic.SyntheticDataset.decode`` derives every
pixel byte from a splitmix32-style counter hash plus a payload-header
mix; this package reproduces that math bit-for-bit on the card —
standalone (:func:`ops.decode_batch`) or fused with crop/flip/normalize
(:func:`repro_torch.kernels.augment.ops.decode_augment_batch_seeded`),
so the augmented tensor is produced in one launch with no decoded image
anywhere.
"""
from repro_torch.kernels.decode.ops import (decode_batch, decode_params,
                                            fused_decode_seed)

__all__ = ["decode_batch", "decode_params", "fused_decode_seed"]
