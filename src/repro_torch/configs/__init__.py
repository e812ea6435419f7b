"""Model configurations the port carries (``get_config``) and ``reduce()``."""
