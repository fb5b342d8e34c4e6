"""Flash attention: the Hopper kernel that replaces the TPU's ``_fa_kernel``
(``flash_attention.py`` holds the wrapper and its plain version)."""
