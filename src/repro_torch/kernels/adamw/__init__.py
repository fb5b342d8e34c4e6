"""AdamW's two passes a leaf for Hopper (``adamw.py`` holds the wrappers;
``optim/adamw.py`` the plain version and the routing)."""
