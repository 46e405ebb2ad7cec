from thunder_tpu_torch.geometry.quaternion import (  # noqa: F401
    quat_mul,
    quat_conj,
    rotate2d,
    rotate3d,
    quat_from_axis_angle,
    quat_from_matrix,
    quat_from_euler,
    euler_from_quat,
    random_quat,
    random_unit2d,
    swing_twist,
)
from thunder_tpu_torch.geometry.symmetry import Symmetry  # noqa: F401
