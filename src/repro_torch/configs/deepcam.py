"""DeepCAM — the paper's own case-study network (§III-B), port of
``repro.configs.deepcam``.

Not an LM: a DeepLabv3+-style segmentation CNN over (B, 768, 1152, 16)
climate images (the paper's input resolution), in two lowerings
(``reference`` / ``fused``, see ``repro_torch.models.deepcam``).  The
``d_model`` field carries the ResNet stem width.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepcam", family="cnn",
    n_layers=50, d_model=64, d_ff=0, vocab_size=0,
    source="paper refs [21],[34],[36]; MLPerf-HPC deepcam",
)

SMOKE = ModelConfig(
    name="deepcam-smoke", family="cnn",
    n_layers=50, d_model=8, d_ff=0, vocab_size=0,
)

# paper input resolution (CAM5 climate snapshots)
IMAGE_HW = (768, 1152)
SMOKE_HW = (64, 96)
