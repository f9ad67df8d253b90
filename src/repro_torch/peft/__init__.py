"""Parameter-efficient fine-tuning: LoRA adapters and their federated
algebra."""
