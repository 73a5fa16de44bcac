"""Host-side native code: the C++ mesh collision engine's bindings."""
