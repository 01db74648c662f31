from .llama import (LlamaConfig, LlamaForCausalLM,  # noqa: F401
                    llama_7b_config, llama_tiny_config,
                    load_reference_arrays)
