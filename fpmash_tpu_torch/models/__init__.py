"""Pipeline-level models: fingerprint front-end, sketch engine, distances."""
