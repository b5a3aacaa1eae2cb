"""CLI commands ported so far: ``sketch`` (fingerprint modes) and ``dist``."""
