from wireframe_tpu_torch.models.wireframe import PointCloudToWireframe  # noqa: F401
