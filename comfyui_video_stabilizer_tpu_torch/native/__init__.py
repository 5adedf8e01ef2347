"""Native host helpers of the port (built with g++ into ``build/`` at first use)."""
