"""The LLaVA captioner (counterpart of supir_tpu/captioner/): CLIP vision
tower, mm projector, Llama decoder with int4/int8 decode GEMVs, agent."""
