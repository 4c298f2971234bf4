"""ABX representation export and voice-conversion synthesis."""
