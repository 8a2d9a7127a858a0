"""HRTF gain tables (numpy; counterpart of rayverb_tpu/hrtf)."""
