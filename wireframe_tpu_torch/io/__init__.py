from wireframe_tpu_torch.io.obj import load_wireframe, save_wireframe  # noqa: F401
from wireframe_tpu_torch.io.xyz import read_xyz  # noqa: F401
