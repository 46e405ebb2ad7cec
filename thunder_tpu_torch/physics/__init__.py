from thunder_tpu_torch.physics.ctf import ctf_1d, ctf_image, ctf_packed, ctf_params  # noqa: F401
from thunder_tpu_torch.physics.kernels import tik_rl, nik_rl, mkb_ft, mkb_rl, mkb_blob_vol  # noqa: F401
from thunder_tpu_torch.physics import spectrum  # noqa: F401
from thunder_tpu_torch.physics import filters  # noqa: F401
from thunder_tpu_torch.physics import mask  # noqa: F401
