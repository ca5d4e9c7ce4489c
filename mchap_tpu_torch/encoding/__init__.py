from mchap_tpu_torch.encoding import character, integer  # noqa: F401
