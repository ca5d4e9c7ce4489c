from mchap_tpu_torch.io import util  # noqa: F401
