from qatzip_tpu_torch.utils.logging import (  # noqa: F401
    QZ_DEBUG, QZ_ERROR, QZ_INFO, QZ_WARN, get_log_level, set_log_level)
