from repro_torch.models import snn_cnn  # noqa: F401
