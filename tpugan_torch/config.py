"""Configuration dataclasses (counterpart of ``tpugan/config.py``).

Flag names and semantics follow the reference CLIs
(E_align_cropping_s1.py:302-316, embedding_v2_styleGAN1.py:194-211):
``--mtype {1: StyleGANv1, 2: StyleGANv2, 3: PGGAN, 4: BigGAN}``,
``--start_features {16->1024, 32->512, 64->256, 128->128}``, ``--z_dim``
(512; BigGAN 128), ``--img_size``, training defaults lr=0.0015,
betas=(0.0, 0.99), batch 2, 210000 iterations. The fields, defaults and
properties are ``tpugan``'s, so a configuration reads the same in both
packages.
"""

from __future__ import annotations

import dataclasses
import math

MTYPE_STYLEGAN1 = 1
MTYPE_STYLEGAN2 = 2
MTYPE_PGGAN = 3
MTYPE_BIGGAN = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    mtype: int = 2
    img_size: int = 1024
    img_channels: int = 3
    z_dim: int = 512
    start_features: int = 16
    maxf: int = 512
    latent_size: int = 512

    @property
    def layer_count(self) -> int:
        # 7 -> 256, 8 -> 512, 9 -> 1024 (E_align_cropping_s1.py:29,65)
        return int(math.log2(self.img_size)) - 1

    @property
    def lod(self) -> int:
        # Gs.forward(w, log2(size)-2) (E_align_cropping_s1.py:109)
        return int(math.log2(self.img_size)) - 2

    @property
    def num_style_layers(self) -> int:
        return 2 * self.layer_count


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 210000
    lr: float = 0.0015
    beta_1: float = 0.0
    beta_2: float = 0.99
    batch_size: int = 2
    case: int = 1  # 1: aligned s1 (detached image losses), 2: aligned s2, 3: mis-aligned grad-cam
    experiment_dir: str | None = None
    checkpoint_dir_gan: str | None = None
    config_dir: str | None = None
    checkpoint_dir_e: str | None = None
    seed_period: int = 30000
    log_every: int = 100
    checkpoint_every: int = 5000
    # knobs without a reference equivalent, as tpugan has them
    space_shards: int = 1  # shard image H across this many devices (e_align, embedding; mtypes 1 and 2)
    remat: bool = False  # recompute each encode and resynthesis in the backward (torch.utils.checkpoint)
    bf16: bool = False  # bfloat16 activations in the frozen generator
