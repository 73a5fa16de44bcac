"""Learned collision models (port of ``sigsvgd_tpu/models/learning``)."""
