"""ABX representation export, voice-conversion synthesis and the
submission validator."""
