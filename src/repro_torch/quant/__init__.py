"""Weight quantization of the port (int4 groups, W4A16 serving)."""
