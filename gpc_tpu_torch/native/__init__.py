"""Native C++ host helpers of the port (built with g++ at first use)."""
