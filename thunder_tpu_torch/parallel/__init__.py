from thunder_tpu_torch.parallel.mesh import (  # noqa: F401
    Layout,
    make_mesh,
    hemi_data_rows,
    replicated_per_hemi,
)
from thunder_tpu_torch.parallel.distributed import (  # noqa: F401
    default_mesh,
    init_multihost,
)
