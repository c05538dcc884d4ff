"""PyTorch port, the plain YOLOv8n detection baseline (configs/models/yolov8.yaml:
no mask heads, no attention, a detection-only loss) against the JAX
package: the model's serving and training checks
(tests/_torch_variant_checks.py, whose docstring states their tolerances).
"""

import pytest

from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)
from tests._torch_variant_checks import VariantChecks

pytestmark = pytest.mark.usefixtures("few_torch_threads")


class TestBaseline(VariantChecks):
    NAME, CFG = "base", "configs/models/yolov8.yaml"
