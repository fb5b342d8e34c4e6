"""SSM scan: the Hopper kernel that replaces the TPU's ``_scan_kernel``
(``ssm_scan.py`` holds the wrapper and its plain version)."""
