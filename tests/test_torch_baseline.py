"""PyTorch port, the plain YOLOv8n detection baseline (configs/models/yolov8.yaml:
no mask heads, no attention, a detection-only loss) against the JAX
package: the model's serving and training checks
(tests/_torch_variant_checks.py, whose docstring states their tolerances).
"""

from tests._torch_variant_checks import VariantChecks


class TestBaseline(VariantChecks):
    NAME, CFG = "base", "configs/models/yolov8.yaml"
