"""The dense decoder LLM that clients fine-tune with LoRA (Alg. 1 Step 1)."""
